"""Multi-device work of the port: the device mesh (``mesh.py``) and the
edge- and map-sharded bundle adjustment (``sharded_ba.py``); mirrors
``mast3r_slam_tpu/parallel``."""
