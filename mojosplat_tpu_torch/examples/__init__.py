"""The port's command-line programs, run as modules,
``python -m mojosplat_tpu_torch.examples.<name>``: ``train_colmap``,
``eval_colmap``, ``train_blender``, ``train_demo``, ``train_surfel_demo``,
``render_sample``, ``orbit_demo``, ``viewer``, ``compress_scene``,
``extract_mesh``, ``benchmark_scaling``, ``benchmark``, ``benchmark_proj``,
``make_synth_colmap``, ``resample_sfm`` and ``record_parity``. Each exposes
``main(argv)`` (the viewer also ``build_viewer(argv)``)."""
