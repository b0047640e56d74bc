"""Scale-out over torch.distributed (counterpart of parallel/): a (dp, mp)
mesh of ranks, one device each; base-sharded and ring kNN, and the
sharded streaming kNN and MaxSim accumulators."""
