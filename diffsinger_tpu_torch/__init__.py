"""PyTorch/CUDA port of diffsinger_tpu for NVIDIA Hopper (H100).

The JAX package ``diffsinger_tpu`` stays the reference; this package mirrors
its subpackage and module names so each module's counterpart is easy to find.
It imports ``torch`` only. Entry points run on ``device="cuda"`` unless the
caller asks for the CPU, and raise when no CUDA device is present.

Hand-written Hopper kernels (CUDA C++ under ``csrc/``, built with ``nvcc`` at
first use into ``build/kernels/``) replace the JAX package's Pallas kernels:
``ops.diffnet_stack`` and ``ops.hifigan_mrf`` for serving, ``ops.diffnet_train``
for training. ``python -m diffsinger_tpu_torch.data.binarize`` and
``python -m diffsinger_tpu_torch.cli`` run the whole path from a corpus on
disk to waveforms on disk.
"""
