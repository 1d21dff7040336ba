"""The port's training driver (``train.train_loop``); the mesh, the
dry-run and the sharding specs come with the multi-device slice."""
