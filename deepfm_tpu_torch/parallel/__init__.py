"""Data-parallel training over ``torch.distributed``: the process group
(mesh.py) and the synchronous step (spmd.py)."""
