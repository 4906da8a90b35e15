"""The port's command-line tools around ``main_torch.py``, each the
counterpart of a script under ``scripts/`` (or of ``bench.py``) with the
same flags, run as ``python -m mast3r_slam_torch.tools.<name>``:
``make_synthetic_clip`` (a rendered clip with its ground truth),
``eval_protocol`` (the benchmark suites, scored by ATE), ``analyze_drive``
(a ``--diag-out`` file against the clip's ground truth), ``segmented_drive``
(a long run as a chain of resumed processes), ``make_rates`` (the protocol
rates of a loop-closure oracle drive), ``sweep_approximations`` (the
fast-path approximations scored by ATE) and ``bench`` (the tracked-FPS
benchmark behind ``bench_torch.py``).  They import neither JAX nor
``cv2``."""
