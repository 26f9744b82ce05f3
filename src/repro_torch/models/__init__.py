"""Model zoo of the port: the decoder LM (dense and MoE), Mamba-2 and
the Griffin hybrid (RG-LRU + local MQA).

The names are exported lazily: the kernels' plain versions import
:mod:`repro_torch.models.layers`, and the models import the kernels.
"""

__all__ = ["DecoderLM", "LMConfig", "Mamba2Config", "Mamba2LM", "RGConfig",
           "RGLM"]

_HOME = {"DecoderLM": "transformer", "LMConfig": "transformer",
         "Mamba2Config": "mamba2", "Mamba2LM": "mamba2",
         "RGConfig": "rglru", "RGLM": "rglru"}


def __getattr__(name: str):
    if name not in _HOME:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib
    return getattr(importlib.import_module(f".{_HOME[name]}", __name__), name)
