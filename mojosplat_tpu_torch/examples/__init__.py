"""The port's command-line programs, run as modules,
``python -m mojosplat_tpu_torch.examples.<name>``: ``train_colmap``,
``eval_colmap``, ``train_blender``, ``train_demo``, ``train_surfel_demo``,
``render_sample``, ``orbit_demo``, ``viewer``, ``compress_scene`` and
``extract_mesh``. Each exposes ``main(argv)`` (the viewer also
``build_viewer(argv)``)."""
