"""spring_tpu — accelerator-batched FASTQ/FASTA compression framework.

A from-scratch rebuild of the capabilities of SPRING
(github.com/shubhamchandak94/Spring): the reorder/match search runs as
batched, fixed-shape integer JAX programs on the accelerator, entropy
coding and byte I/O run in native C++ (csrc/), and multi-device scaling
uses jax.sharding meshes (parallel/).
"""
import os as _os

# fixed path: the cache directory is part of the cache key, so a path that
# moved between runs would never hit
_DEFAULT_CACHE = _os.path.abspath(
    _os.path.join(_os.path.dirname(__file__), "..", ".jax_cache"))


def _enable_compile_cache() -> None:
    """Persistent XLA compilation cache — the reorder round program is large
    and recompiling it per process dominates small-input runs. Where
    JAX_COMPILATION_CACHE_DIR is set, JAX already uses it and nothing is
    set here; otherwise the cache lives at <checkout>/.jax_cache."""
    if _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    import jax
    jax.config.update("jax_compilation_cache_dir", _DEFAULT_CACHE)


def _raise_mmap_threshold() -> None:
    """Keep big numpy buffers in the malloc arena instead of per-allocation
    mmaps. glibc mmaps allocations over 128 KB and unmaps them on free, so
    every block-sized matrix the pipeline allocates refaults its pages —
    on this class of VM (lazily-backed memory) that costs ~30 MB/s and
    swings stage times 2-3x between runs. Raising M_MMAP_THRESHOLD lets
    freed buffers be reused with their pages still resident. Opt out with
    SPRING_TPU_MALLOC_ARENA=0 (the arena retains freed peaks until trim)."""
    if _os.environ.get("SPRING_TPU_MALLOC_ARENA", "1") == "0":
        return
    try:
        import ctypes
        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        M_MMAP_THRESHOLD = -3
        libc.mallopt(M_MMAP_THRESHOLD, 1 << 29)
    except Exception:   # non-glibc platform — purely an optimization
        pass


_raise_mmap_threshold()
_enable_compile_cache()
