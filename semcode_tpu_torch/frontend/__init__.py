"""Frontends: the built-in web UI (served by the API at /) and the
launcher."""
