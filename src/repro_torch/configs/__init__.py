"""Architecture configs (port of ``repro.configs``).  ``get_config(name)``
resolves each architecture the port runs."""

from repro_torch.configs.base import (  # noqa: F401
    SHAPES,
    ArchConfig,
    ShapeSpec,
    get_config,
    list_archs,
)
