from .metadata import MetadataStore, compile_filter  # noqa: F401
from .store import DeviceIndex, IndexConfig  # noqa: F401
