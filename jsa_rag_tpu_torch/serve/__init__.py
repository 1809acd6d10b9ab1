from .server import IndexServer  # noqa: F401
from .client import call_retrieve_api, call_rebuild_api  # noqa: F401
