from .visualization import SLAMViewer, run_visualization  # noqa: F401
