"""Parallelism over a ``torch.distributed`` process group: the processes
(``multihost``), the ``parallelism`` config key, the mesh, data and tensor
parallelism and the parameter layouts (``mesh``), GPipe pipeline
parallelism (``pipeline``), the index-sharded retrieval (``retrieval``)."""
