"""Data-parallel training across GPUs: one process per GPU.

``mesh``: the JAX package's mesh axes over a ``torch.distributed`` world
(``train.mesh.data`` / ``train.mesh.slice``), the rank's rows of the global
batch, and the collectives of a step; ``feed``: a rank's local block
against the global batch; ``launch``: the ranks a command starts itself.
"""
