"""The published peaks of one NVIDIA H100 SXM (H100 80GB HBM3) that every
roofline and MFU share of this benchmark divides by: NVIDIA's data sheet,
dense rates without sparsity, at the full power limit of 700 W.

The configurations compute float32. The fastest rate at which the card
multiplies float32 inputs is the TF32 tensor-core rate, so no float32
implementation can read above 100% of it.
"""

TF32_FLOPS = 495e12
HBM_BYTES_PER_S = 3.35e12
