"""Device compute ops: the windowed-sinc convolution core.

``convolve`` is the reference formulation (gather + masked MAC);
``resample`` holds the uniform-ratio launch route used on the hot path. Both
are bit-exact against the C reference and against each other
(tests/test_resample_ops.py).
"""

from clownresampler_tpu.ops.convolve import ConfigScalars, convolve_frames

__all__ = ["ConfigScalars", "convolve_frames"]
