"""The dp x tp x cp mesh of the parallel train and eval steps: the mesh
and its process groups (mesh.py), the collectives the steps use
(comm.py) and the process runtime (distributed.py)."""
