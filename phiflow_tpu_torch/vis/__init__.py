"""Visualisation and interactive tooling — port of `phiflow_tpu/vis`: the
matplotlib recipes (imported lazily: the package and `flow` import without
matplotlib or plotly), console ASCII plots, scene scalar logging, the
`Viewer` run loop and the std-lib web GUI. The recipes read the port's
Fields and Tensors as host arrays (`Tensor.numpy`), wherever they lie."""
from ._vis import plot, show, show_hist, close, control, action, overlay, write_image, plot_scalars, smooth
from ._vis_base import VisModel, Control, Action, benchmark, play_async, Recipe, PlottingLibrary, Gui
from ._viewer import Viewer, Record, view, create_viewer
from ._log import SceneLog, load_scalars
from ._web import WebGui, web_view
from . import _console as console
