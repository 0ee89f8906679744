"""Token mixers: the ADN-SSD mixer and softmax attention (NCHW)."""
