"""The port's launch layer: the training loop (``train.train_loop``),
device meshes over a process group (``mesh``) and shape stand-ins of
every step's inputs on the meta device (``specs``)."""
