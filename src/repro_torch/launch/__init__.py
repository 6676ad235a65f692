"""Launchers of the port: :mod:`repro_torch.launch.serve` (the zoo's
continuous-batch serving loop)."""
