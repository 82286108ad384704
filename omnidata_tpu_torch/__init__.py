"""PyTorch/CUDA port of omnidata_tpu's device annotator.

Module paths mirror ``omnidata_tpu`` so each counterpart is easy to find.
Plain tensor code is PyTorch; the raster kernel is CUDA C++ for Hopper
(``csrc/``), built with nvcc at first use (``_build.py``). The package
imports torch and numpy only.
"""
