"""Runtime services of the PyTorch port: signal extraction, result
recording (``.sca.json`` / ``.vec.npz`` and the Scave text twins),
checkpointing, trails and analysis."""
from .signals import extract_signals, summarize  # noqa: F401
from .recorder import load_scalars, load_vectors, record_run  # noqa: F401
from . import checkpoint  # noqa: F401
from .analysis import analyze, render_report  # noqa: F401
from .scave import export_scave, read_sca, read_vec  # noqa: F401
