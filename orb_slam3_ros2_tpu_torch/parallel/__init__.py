"""Sharded solvers and multi-process sessions over `torch.distributed`."""
