from .report import (print_red, print_green, print_blue, tabulate_simple,
                     ResultWriter)
from .dump import (dump_system, load_system, load_coupling,
                   write_solution, read_solution)
from .datfile import parse_dat_file, dat_to_amg_parameters

__all__ = ["print_red", "print_green", "print_blue", "tabulate_simple",
           "ResultWriter", "dump_system", "load_system", "load_coupling",
           "write_solution",
           "read_solution", "parse_dat_file", "dat_to_amg_parameters"]
