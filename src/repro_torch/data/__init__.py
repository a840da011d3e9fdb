"""Study data for the port: Algorithm 3 and horizontal partitioning."""
from .datasets import STUDIES, Study, load_study
from .partition import partition_rows, ragged_sizes, split_rows
from .synthetic import SyntheticStudy, generate_synthetic

__all__ = ["STUDIES", "Study", "SyntheticStudy", "load_study", "generate_synthetic", "partition_rows",
           "ragged_sizes", "split_rows"]
