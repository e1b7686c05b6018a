"""Launchers of the port (twin of the JAX package's ``repro.launch``, its
serving half): :mod:`repro_torch.launch.serve` (the batched, sharded, online
and fleet serving launcher), :mod:`repro_torch.launch.serve_lifecycle` (one
server or a fleet with the index lifecycle behind ``--refresh``) and
:mod:`repro_torch.launch.mesh` (the ``--mesh`` process group and
DeviceMesh).  Importing them builds nothing and opens no process group."""
