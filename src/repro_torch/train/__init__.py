"""Training and serving steps, checkpoints and fault tolerance (the
counterpart of ``repro.train``, one device)."""
