"""Frontend launcher.

Counterpart of ``semcode_tpu/frontend/cli.py``: shells out to ``streamlit
run`` on the client app (``frontend/app.py``) when streamlit is installed;
otherwise points the user at the dependency-free built-in web UI served by
the API.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

from ..settings import settings


def main() -> int:
    try:
        import streamlit  # noqa: F401
    except ImportError:
        print(
            "streamlit is not installed. The built-in web UI is served by the "
            f"API at {settings.frontend_api_root}/ — start it with "
            "`semcode-tpu-torch serve`.",
            file=sys.stderr,
        )
        return 1
    app_path = Path(__file__).with_name("app.py")
    cmd = [
        sys.executable,
        "-m",
        "streamlit",
        "run",
        str(app_path),
        "--server.port",
        str(settings.frontend_port),
    ]
    return subprocess.call(cmd)


if __name__ == "__main__":
    raise SystemExit(main())
