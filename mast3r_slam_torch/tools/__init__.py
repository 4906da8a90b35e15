"""The port's command-line tools around ``main_torch.py``, each the
counterpart of a script under ``scripts/`` with the same flags, run as
``python -m mast3r_slam_torch.tools.<name>``: ``make_synthetic_clip``
(a rendered clip with its ground truth), ``eval_protocol`` (the benchmark
suites, scored by ATE), ``analyze_drive`` (a ``--diag-out`` file against
the clip's ground truth) and ``segmented_drive`` (a long run as a chain of
resumed processes).  They import neither JAX nor ``cv2``."""
