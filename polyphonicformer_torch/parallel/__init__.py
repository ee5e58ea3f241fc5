"""Distributed execution of the port: the (data, model) mesh over
``torch.distributed`` (:mod:`.mesh`) and Megatron-style tensor-parallel
linears (:mod:`.tensor_parallel`)."""
