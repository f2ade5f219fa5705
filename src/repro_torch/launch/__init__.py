"""Launchers of the port: the train launcher (``python -m
repro_torch.launch.train``), the serve launcher (``launch.serve``), the
worker node (``launch.node``) and the three-process serve mesh
(``launch.serve_mesh``). The mesh and dry-run launchers of the JAX
package are still to be ported (ROADMAP A10, A11)."""
