"""The benchmark of the PyTorch and CUDA port (``deepfm_tpu_torch``):
training cells on the card, driven through the port's normal entry
points and held to a plain float32 reference.  README.md says how to run
it and how to add a configuration, a traffic mix or a metric."""
