"""`allreduce_ms.dp4`: device ms a step of the NCCL kernels on rank 0, the union of their intervals (`benchlib.links.allreduce_ms`)."""

from benchlib.links import allreduce_ms as read  # noqa: F401
