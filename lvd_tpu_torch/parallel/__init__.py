"""Frame-sharded sampling and the trainer's ("data", "model") mesh over
torch.distributed: the collectives (comm.py), the mesh and its sharding
rules (mesh.py), the collective census (audit.py) and ranks in processes
of one host (launch.py)."""
