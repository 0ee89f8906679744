"""Layers, wavelet convolutions and composite blocks (NCHW)."""
