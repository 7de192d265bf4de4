"""pointcloudmatters_tpu — JAX rebuild of PointCloudMatters / OBSBench.

JAX / XLA / Pallas framework for behavior-cloning manipulation policies
(ACT, Diffusion Policy) under RGB / RGB-D / point-cloud observation spaces.
"""

__version__ = "0.1.0"
