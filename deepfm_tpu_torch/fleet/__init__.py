"""Fleet control plane: the port keeps only the hash-stable split point and
sampling gate (split.py) that the flywheel's sampling shares with JAX.  The
tenant registry, shadow scoring and traffic splits wait for the serving
pool (ROADMAP A14)."""
