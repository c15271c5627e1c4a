"""Architecture configs (assigned pool) + input-shape registry."""
from repro_torch.configs.registry import (  # noqa: F401
    ARCHS, SHAPES, get_config, get_smoke_config, cell_is_skipped)
