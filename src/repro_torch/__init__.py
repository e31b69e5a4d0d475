"""repro_torch — the stencil compilation stack on PyTorch and CUDA.

A port of ``repro`` (JAX on a TPU) to PyTorch on an NVIDIA H100.  The
compile surface lives in ``repro_torch.api`` and is re-exported here:

    import repro_torch
    step = repro_torch.compile(program, repro_torch.Target(backend="cuda"))

Imports are lazy so ``import repro_torch`` stays light (no torch import
until the API is touched).
"""

__all__ = [
    "api",
    "obs",
    "tune",
    "resilience",
    "Program",
    "Target",
    "TargetError",
    "CompiledStencil",
    "compile",
    "cache_stats",
    "clear_cache",
    "resilient_loop",
    "resume",
]


def __getattr__(name: str):
    if name == "obs":
        import repro_torch.obs as obs

        return obs
    if name == "tune":
        import repro_torch.tune as tune

        return tune
    if name == "resilience":
        import repro_torch.resilience as resilience

        return resilience
    if name in __all__:
        import repro_torch.api as api

        return api if name == "api" else getattr(api, name)
    raise AttributeError(f"module 'repro_torch' has no attribute {name!r}")


def __dir__():
    return sorted(__all__)
