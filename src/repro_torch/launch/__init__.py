"""Command-line entry points of the port (``python -m
repro_torch.launch.train``, ``.serve``, ``.dryrun``).

The dry run's functions (``run_cell``, ``count_cell``, ``build_cell``,
``input_specs``, ``active_params``, ``save_report``) live in
``repro_torch.launch.dryrun`` and the one-device layout (``SINGLE``) and
the meshes of ranks (``make_smoke_mesh``) in ``repro_torch.launch.mesh``;
import them from there.
"""
