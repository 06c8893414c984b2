from .report import (print_red, print_green, print_blue, tabulate_simple,
                     ResultWriter)

__all__ = ["print_red", "print_green", "print_blue", "tabulate_simple",
           "ResultWriter"]
