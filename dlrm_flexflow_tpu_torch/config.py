"""Runtime configuration + CLI parsing.

PyTorch counterpart of `dlrm_flexflow_tpu/config.py`: `FFConfig` keeps every
field name, default and flag spelling of the JAX package, so one argv gives
the same config in both. The serving path of this package reads
`batch_size`, `seed`, `compute_dtype`, `use_pallas` and
`onehot_embedding_threshold`; the other fields are carried for parity and
are read by later parts of the port (training, packed tables, meshes).
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import List, Optional, Sequence, Tuple


@dataclasses.dataclass
class FFConfig:
    # --- training loop (reference: config.h:112-120) ---
    epochs: int = 1
    batch_size: int = 64
    print_freq: int = 10
    # --- optimizer defaults ---
    learning_rate: float = 0.01
    weight_decay: float = 0.0001
    # --- dataset ---
    dataset_path: str = ""
    # --- devices / mesh ---
    num_nodes: int = 1
    devices_per_node: int = -1  # -1 => all local devices
    mesh_shape: Optional[Tuple[int, ...]] = None
    mesh_axis_names: Tuple[str, ...] = ("data",)
    chips_per_host: int = 0
    # --- auto-parallelization search (reference: config.h:125-130) ---
    search_budget: int = 0
    search_alpha: float = 0.05
    search_overlap_backward_update: bool = False
    enable_parameter_parallel: bool = False
    enable_attribute_parallel: bool = False
    enable_propagation: bool = False
    import_strategy_file: str = ""
    export_strategy_file: str = ""
    export_strategy_task_graph_file: str = ""
    # --- simulator / machine model (reference: config.h:133-139) ---
    machine_model_version: int = 0
    machine_model_file: str = ""
    simulator_segment_size: int = 16777216
    simulator_max_num_segments: int = 1
    # --- execution knobs ---
    profiling: bool = False
    perform_fusion: bool = False
    fuse_embeddings: bool = False
    # Embedding tables with vocab <= this take the one-hot path (rows
    # rounded to compute_dtype, f32 sum); larger ones an exact f32 gather.
    onehot_embedding_threshold: int = 8192
    onehot_packed_threshold: int = 0
    allow_tensor_op_math: bool = True
    # Kernel routing: "auto" launches the hand-written kernels where the
    # JAX package picks its Pallas kernel and the model lives on CUDA, "on"
    # forces the ported kernels (their plain versions on the CPU), "off"
    # is plain PyTorch.
    use_pallas: str = "auto"
    packed_tables: str = "auto"
    packed_min_rows: int = 4096
    exchange: str = "dense"
    host_routing: bool = False
    host_tail_threshold: int = 0
    host_tail_cap_frac: float = 0.0625
    packed_gather_mode: str = "auto"
    packed_stream_mode: str = "auto"
    packed_selective: str = "on"
    table_dtype: str = "float32"
    compute_dtype: str = "bfloat16"  # activations/matmul dtype; params stay f32
    seed: int = 42
    # --- runtime-adjustable iteration config (reference: config.h:156-161) ---
    seq_length: int = -1

    @property
    def num_devices(self) -> int:
        if self.mesh_shape is not None:
            n = 1
            for d in self.mesh_shape:
                n *= d
            return n
        if self.devices_per_node == -1:
            import torch

            return torch.cuda.device_count()
        return self.num_nodes * self.devices_per_node

    def machine_cache_path(self) -> str:
        """The machine file the strategy search calibrates into and reads
        back (the JAX package's `machine_cache_path`): machine_model_file,
        else beside the exported strategy, else the port's own
        `build/ffsim_machine_h100.json` under the checkout's ignored build
        directory. The JAX package's TPU calibration, the root
        `.ffsim_machine.json`, is never the port's default."""
        if self.machine_model_file:
            return self.machine_model_file
        if self.export_strategy_file:
            return self.export_strategy_file + ".machine.json"
        return str(Path(__file__).resolve().parents[1] / "build" / "ffsim_machine_h100.json")

    @staticmethod
    def parse_args(argv: Optional[Sequence[str]] = None) -> "FFConfig":
        cfg = FFConfig()
        cfg.update_from_args(argv)
        return cfg

    def update_from_args(self, argv: Optional[Sequence[str]] = None) -> List[str]:
        """Consume known flags (reference flag spelling, model.cc:2282); return the rest."""
        import sys

        args = list(sys.argv[1:] if argv is None else argv)
        rest: List[str] = []
        i = 0

        def take() -> str:
            nonlocal i
            i += 1
            return args[i]

        while i < len(args):
            a = args[i]
            if a in ("-e", "--epochs"):
                self.epochs = int(take())
            elif a in ("-b", "--batch-size"):
                self.batch_size = int(take())
            elif a in ("--lr", "--learning-rate"):
                self.learning_rate = float(take())
            elif a in ("--wd", "--weight-decay"):
                self.weight_decay = float(take())
            elif a in ("-p", "--print-freq"):
                self.print_freq = int(take())
            elif a in ("-d", "--dataset"):
                self.dataset_path = take()
            elif a in ("--budget", "--search-budget"):
                self.search_budget = int(take())
            elif a in ("--alpha", "--search-alpha"):
                self.search_alpha = float(take())
            elif a == "--search-overlap-backward-update":
                self.search_overlap_backward_update = True
            elif a in ("--import", "--import-strategy"):
                self.import_strategy_file = take()
            elif a in ("--export", "--export-strategy"):
                self.export_strategy_file = take()
            elif a in ("--taskgraph", "--export-strategy-task-graph-file"):
                self.export_strategy_task_graph_file = take()
            elif a == "--enable-parameter-parallel":
                self.enable_parameter_parallel = True
            elif a == "--enable-attribute-parallel":
                self.enable_attribute_parallel = True
            elif a == "--enable-propagation":
                self.enable_propagation = True
            elif a == "--nodes":
                self.num_nodes = int(take())
            elif a in ("--devices-per-node", "-ll:gpu"):
                self.devices_per_node = int(take())
            elif a == "--mesh":
                self.mesh_shape = tuple(int(x) for x in take().split("x"))
            elif a == "--chips-per-host":
                self.chips_per_host = int(take())
            elif a == "--profiling":
                self.profiling = True
            elif a == "--fusion":
                self.perform_fusion = True
            elif a == "--allow-tensor-op-math":
                self.allow_tensor_op_math = True
            elif a == "--compute-dtype":
                self.compute_dtype = take()
            elif a == "--use-pallas":
                self.use_pallas = take()
            elif a == "--packed-tables":
                self.packed_tables = take()
            elif a == "--exchange":
                self.exchange = take()
            elif a == "--host-routing":
                self.host_routing = True
            elif a == "--host-tail-threshold":
                self.host_tail_threshold = int(take())
            elif a == "--host-tail-cap-frac":
                self.host_tail_cap_frac = float(take())
            elif a == "--packed-gather-mode":
                self.packed_gather_mode = take()
            elif a == "--packed-stream-mode":
                self.packed_stream_mode = take()
            elif a == "--packed-selective":
                self.packed_selective = take()
            elif a == "--table-dtype":
                self.table_dtype = take()
            elif a == "--machine-model-version":
                self.machine_model_version = int(take())
            elif a == "--machine-model-file":
                self.machine_model_file = take()
            elif a == "--simulator-segment-size":
                self.simulator_segment_size = int(take())
            elif a == "--simulator-max-num-segments":
                self.simulator_max_num_segments = int(take())
            elif a == "--seed":
                self.seed = int(take())
            else:
                rest.append(a)
            i += 1
        return rest


@dataclasses.dataclass
class FFIterationConfig:
    """Per-iteration runtime knobs (reference: include/config.h:156-161)."""

    seq_length: int = -1

    def reset(self) -> None:
        self.seq_length = -1
