"""Launchers of the port: the serve launcher (``python -m
repro_torch.launch.serve``). The serve-mesh, train and dry-run launchers
of the JAX package are still to be ported (ROADMAP A9, A10, A11)."""
