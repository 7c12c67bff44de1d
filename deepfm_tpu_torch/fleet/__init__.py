"""Fleet control plane: the port keeps only the hash-stable split point and
sampling gate (split.py) that the flywheel's sampling shares with JAX.  The
serving pool (serve/pool/) serves one tenant, JAX's ``DEFAULT_TENANT``; the
tenant registry, shadow scoring and traffic splits are ROADMAP A18."""
