"""The Mamba2 mixer's single-token decode step between its projections,
in one launch (``csrc/mixer_decode.cu``)."""
