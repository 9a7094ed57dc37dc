"""Host-side table ingestion (resource lookup, ASCII tables, RFM k-tables)."""

from .ascii import (decomment_file, get_num_cols, get_num_rows,
                    read_aerosol_profile, read_data_table, read_data_vector,
                    read_stellar_flux)
from .resource import (add_resource_directory, find_resource,
                       get_search_paths, set_search_paths)
from .rfm import RFMTable, load_rfm_table, read_weights_rfm, write_rfm_table

__all__ = ["decomment_file", "read_data_table", "get_num_cols",
           "get_num_rows", "read_data_vector", "read_aerosol_profile",
           "read_stellar_flux",
           "find_resource", "add_resource_directory", "set_search_paths",
           "get_search_paths",
           "RFMTable", "load_rfm_table", "read_weights_rfm",
           "write_rfm_table"]
