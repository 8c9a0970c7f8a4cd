"""Data and tensor parallelism on ``torch.distributed``: the process mesh,
batch and parameter placement and the global reductions (``mesh.py``), and
parameters sharded over the mesh's model axis (``tensor_parallel.py``)."""
