"""Parallelism across processes: data parallelism over a torch.distributed group."""
