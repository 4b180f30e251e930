"""The PIM side of EPIM (counterpart of ``repro.pim``): layer inventories
of the paper's networks (workloads.py), crossbar mapping and #XB counting
(xbar.py), the latency/energy lookup table (tables.py) and behaviour-level
simulator (simulator.py), the analytic cost model (costmodel.py), the
Algorithm-1 evolution search (evo.py), and plan.py, which turns every
design path into a serializable EpitomePlan and legalizes searched specs
to the kernel-exact families so that they run through the fused kernels.
"""
from .xbar import MappingConfig, count_crossbars, layer_crossbars, make_spec
from .workloads import (LayerShape, lm_layers, resnet50_layers,
                        resnet101_layers, tiny_resnet_layers)
from .simulator import PimSimulator, SimResult
from .costmodel import (AnalyticCost, CostModel, LayerCost, PlanCost,
                        analytic_cost_for, cost_model_for)
from .evo import EvoConfig, encode_individual, evolution_search
from .plan import (EpitomePlan, LayerPlan, PlanSchemaError, auto_plan,
                   is_kernel_exact, legalize_plan, legalize_spec, pack_grid,
                   plan_conv_specs, plan_from_specs, search_plan,
                   uniform_plan, validate_plan_dict)
