"""Launchers (port of ``repro.launch``): the single-process training
launcher (:mod:`repro_torch.launch.train`) and the slice-granular
re-meshing policy (:mod:`repro_torch.launch.elastic`)."""
