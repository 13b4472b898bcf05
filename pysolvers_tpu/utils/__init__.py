from .timing import Timer
from .tab import Tab
from .profiling import SpeedOfLight, measure, trace, spmv_sol
from .checkpoint import (save_pytree, load_pytree, save_solve_state,
                         load_solve_state)
from .matrix_graph import matrix_graph_dot, write_matrix_graph
from .tabulate import LatexSafeTemplate, latex_table, render_template

__all__ = ["Timer", "Tab", "SpeedOfLight", "measure", "trace",
           "spmv_sol",
           "save_pytree", "load_pytree", "save_solve_state",
           "load_solve_state",
           "matrix_graph_dot", "write_matrix_graph",
           "LatexSafeTemplate", "latex_table", "render_template"]
