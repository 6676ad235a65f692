"""Launchers of the port: :mod:`repro_torch.launch.serve` (the zoo's
continuous-batch serving loop), :mod:`repro_torch.launch.train` (the
zoo's training loop) and their step functions
(:mod:`repro_torch.launch.steps`)."""
