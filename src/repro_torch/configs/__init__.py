"""Architecture configs (port of ``repro.configs``).  ``get_config(name)``
resolves each architecture the port runs."""

from repro_torch.configs.base import ArchConfig, get_config, list_archs  # noqa: F401
