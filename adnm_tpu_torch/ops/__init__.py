"""Kernels and the plain tensor ops around them."""


def build_kernels(names) -> None:
    """Build the named CUDA kernel libraries (K1 and K3: ``rms_norm``; K2:
    ``ssd_scan``) without loading them: a parent builds them once before it
    starts data-parallel ranks, which then load them."""
    from adnm_tpu_torch.ops import _build, rms_norm, ssd

    sources = {"rms_norm": rms_norm.SOURCES, "ssd_scan": ssd.SOURCES}
    for name in names:
        _build.build_library(name, sources[name])
