"""Config tier of the PyTorch port: ini-style wildcard overrides (the
omnetpp.ini analog)."""
from .ini import Config, build_from_config, parse_value  # noqa: F401
