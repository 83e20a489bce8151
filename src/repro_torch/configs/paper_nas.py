"""The paper's own architecture space (§4.3.2) as a selectable config.

Unlike the LM-family entries, the paper's subject is a conv-net NAS
space; `--arch paper-nas` resolves here and the launch APIs accept a
seed to pick one sample.
"""
from repro_torch.core.nas_space import NASSpaceConfig, sample_architecture

SPACE = NASSpaceConfig(resolution=64)


def sample(seed: int = 0):
    return sample_architecture(seed, SPACE)
