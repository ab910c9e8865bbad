"""Parallelism over a ``torch.distributed`` process group: the processes
(``multihost``), data parallelism and the ``parallelism`` config key
(``mesh``), the index-sharded retrieval (``retrieval``)."""
