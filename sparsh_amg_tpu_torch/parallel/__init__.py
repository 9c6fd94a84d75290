"""The distributed solver over ``torch.distributed`` (the port of
``sparsh_amg_tpu/parallel``).

The reference distributes with MPI: contiguous row blocks per rank, halo
Isend/Irecv around the local SpMV, MPI_Allreduce for dots.  The port does
the same with one process per rank: each rank holds its row block of
every level on its own device, halos move point to point, dots are
all-reduces, and the small coarse levels are replicated on every rank
behind one all-gather.
"""
from .partition import Partition
from .dist import (DistDense, DistDia, DistEll, GatherOut, RankGroup,
                   ReplSrc, csr_to_dist, pdot)
from .hierarchy import DistHierarchy, DistLevel, to_dist
from .solver import DistAMGSolver
from .multihost import init_process_group, launch_processes

__all__ = [
    "Partition", "DistDia", "DistEll", "DistDense", "GatherOut", "ReplSrc",
    "RankGroup", "csr_to_dist", "pdot", "to_dist", "DistHierarchy",
    "DistLevel", "DistAMGSolver", "init_process_group", "launch_processes",
]
