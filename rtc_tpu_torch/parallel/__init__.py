"""Sharded rendering over a torch.distributed rank grid (counterpart of
rtc_tpu/parallel/).

  mesh.py         the ('rays', 'prims') grid of ranks (make_mesh) and the
                  grid of the sharded call in progress
  collectives.py  the gathers and reductions over one axis of the grid
  shard.py        pad_tris, shard_scene, the Morton deal, render_sharded
  multihost.py    initialize, render_multihost, train_step_multihost

Importing the package imports none of its modules (the integrator imports
mesh and collectives, and shard imports the integrator).
"""
