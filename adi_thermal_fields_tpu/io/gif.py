"""GIF frame writers' optional dependencies (matplotlib, imageio).

Only the GIF writers of the CLI apps need them; the simulation path
imports neither.  Pass ``--out ''`` to an app to skip its GIF."""
from __future__ import annotations

__all__ = ["gif_modules"]


def gif_modules():
    """Return ``(pyplot, imageio)`` with the Agg backend, or raise
    ``SystemExit`` naming the missing package."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import imageio.v2 as imageio
        import matplotlib.pyplot as plt
    except ImportError as e:
        raise SystemExit(f"writing a GIF needs matplotlib and imageio "
                         f"({e}); install them or pass --out '' to skip "
                         "the GIF") from e
    return plt, imageio
