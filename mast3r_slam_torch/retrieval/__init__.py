"""ASMK retrieval: the feature head, the codebook and inverted file, and the
database the pipeline queries for loop-closure and relocalization
candidates (``mast3r_slam_tpu/retrieval``)."""
