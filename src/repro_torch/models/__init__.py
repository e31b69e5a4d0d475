"""The language models (port of ``repro.models``): layers, attention, MoE,
Mamba, xLSTM and their assembly in ``lm``."""
