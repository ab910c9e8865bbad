"""Parallelism over a ``torch.distributed`` process group: the processes
(``multihost``), the ``parallelism`` config key, the mesh, data and tensor
parallelism and the parameter layouts (``mesh``), GPipe pipeline
parallelism (``pipeline``), ring-attention sequence parallelism
(``sequence``), the index-sharded retrieval (``retrieval``)."""
