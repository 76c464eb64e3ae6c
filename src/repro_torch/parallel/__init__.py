"""Multi-rank training's substrate, below the models: the mesh and the cut
of a tensor to its shard (:mod:`.mesh`), and the collectives with their
autograd pairs (:mod:`.collectives`).  The rules that give each tensor
its spec are the training layer's (:mod:`repro_torch.train.sharding`)."""
