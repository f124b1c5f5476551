"""Training and serving steps, checkpoints and fault tolerance (the
counterpart of ``repro.train``), on one device or a mesh of ranks."""
