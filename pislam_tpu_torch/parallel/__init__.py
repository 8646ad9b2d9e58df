"""The distributed layer on torch.distributed: the (data, model) mesh,
sharded matching, distributed BA, data-parallel streams and checkpointed
multi-process running."""
