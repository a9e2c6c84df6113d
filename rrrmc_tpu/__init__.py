"""rrrmc_tpu: a batched many-chain Monte-Carlo framework for Ising spin
models, on an accelerator, with the capability surface of RRRMC.jl (samplers x models x
observables) re-architected for JAX/XLA/Pallas.

Where the reference advances one chain with O(1) incremental bookkeeping on a
CPU (/root/reference/src/RRRMC.jl), this framework advances thousands of
chains in lockstep with vectorized kernels, shards chains / disorder /
temperatures over device meshes, and keeps the same sampler semantics
(Metropolis, reduced-rejection-rate, rejection-free BKL, waiting-time method,
tau-extremal-optimization).
"""

from .core.model import Model, random_spins
from .core.struct import pytree, static
from .models.pairwise import Pairwise, make_pairwise
from .models.composite import Double, Mixed, mixed
from .models.graphs import (
    GraphEA, GraphEANormal, GraphEANormalDiscretized,
    GraphRRG, GraphRRGNormal, GraphRRGNormalDiscretized,
    GraphIsing1D, GraphFields, GraphFieldsNormalDiscretized,
    GraphEmpty, GraphTwoSpin, GraphThreeSpin,
    GraphEAFromFile, load_ea_instance,
)
from .models.dense import (FullyConnected, GraphSK, GraphSKNormal,
                           make_fully_connected, densify)
from .models.replicas import (
    GraphQT, GraphQuant, QuantModel, four_K, transverse_mag,
    GraphRE, GraphRobustEnsemble, REModel,
    GraphLE, GraphLocalEntropy, LEModel,
    GraphTLE, GraphTopologicalLocalEntropy, TLEModel,
    GraphAF, GraphAddFields, GraphAddSubFields, Replicated, Scaled,
)
from .models.aliases import (
    GraphQ0T, GraphQSKT, GraphQSKNormalT, GraphQEAT,
    Graph0RE, GraphSKRE, GraphEARE,
    Graph0LE, GraphSKLE, GraphEALE,
    Graph0TLE, GraphSKTLE, GraphEATLE,
)
from .models.flatten import flatten
from .models.pspin import GraphPSpin3, PSpin3
from .models.lattice import LatticeEA
from .models.sat import (GraphSAT, SATModel, make_sat, export_cnf,
                         GraphSATRE, GraphSATLE, GraphSATTLE)
from .models.perceptron import (
    Perceptron, GraphPercStep, GraphPercLinear, GraphPercXEntr,
    GraphQPercStepT, GraphQPercLinearT,
    GraphPercStepRE, GraphPercLinearRE, GraphPercStepLE, GraphPercLinearLE,
)
from .models.committee import (
    Committee, GraphCommStep, GraphCommReLU, GraphCommQu,
    GraphQCommStepT, GraphQCommReLUT, GraphQCommQuT,
    GraphCommStepRE, GraphCommReLURE, GraphCommQuRE,
    GraphCommStepLE, GraphCommReLULE, GraphCommQuLE,
)
from .samplers.metropolis import standardMC
from .samplers.sweep import sweepMC
from .samplers.dense_sweep import sweepMC_dense
from .samplers.rrr import rrrMC
from .samplers.bkl import bklMC
from .samplers.wtm import wtmMC
from .samplers.eo import extremal_opt, EOResult
from .samplers.common import (MCState, init_state, rebind, DEFAULT_SEED,
                              LAST_ROUTE, choose_route)
from .parallel.tempering import (parallel_tempering, tempered_ensembles,
                                 energies_by_rank, sweep_kernel)
from . import observables
from . import analysis
from . import experiments
from .utils.checkpoint import save_state, load_state
from .utils import profiling

__version__ = "0.1.0"
