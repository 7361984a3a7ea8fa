"""Core datatypes for the DREAM scheduler and its discrete-event simulator.

These types describe the paper's Level-1 world: layer-granularity model
graphs, RTMM pipelines (models with FPS targets, deadlines and control
dependencies), and multi-accelerator systems built from weight-stationary
(WS, NVDLA-like) and output-stationary (OS, ShiDianNao-like) sub-accelerators
(Table 2 of the paper).
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, replace
from typing import Optional

MiB = 1 << 20


class OpType(enum.Enum):
    """Operator families the analytical cost model distinguishes."""

    CONV2D = "conv2d"      # dense convolution: K,C,R,S,Y,X
    DWCONV = "dwconv"      # depthwise convolution: C,R,S,Y,X (K==C, groups==C)
    FC = "fc"              # fully connected / GEMV: K (out), C (in), M tokens in Y
    GEMM = "gemm"          # batched matmul: M=Y, N=K, K-dim=C
    POOL = "pool"          # pooling / elementwise: C,Y,X (bandwidth bound)
    RNN = "rnn"            # recurrent cell step (treated as FC with state)


@dataclass(frozen=True)
class Layer:
    """A single schedulable layer (the paper's scheduling granularity).

    Dimensions follow the MAESTRO convention:
      K out channels, C in channels, R x S filter, Y x X *output* spatial.
    FC/GEMM layers use Y as the token/batch (M) dimension with R=S=X=1.
    """

    name: str
    op: OpType
    K: int = 1
    C: int = 1
    R: int = 1
    S: int = 1
    Y: int = 1
    X: int = 1
    bytes_per_elem: int = 2  # fp16 activations/weights (MAESTRO-style tables)

    @property
    def macs(self) -> int:
        if self.op is OpType.DWCONV:
            return self.C * self.R * self.S * self.Y * self.X
        if self.op is OpType.POOL:
            return self.C * self.Y * self.X  # elementwise-ish work
        return self.K * self.C * self.R * self.S * self.Y * self.X

    @property
    def weight_bytes(self) -> int:
        if self.op is OpType.DWCONV:
            return self.C * self.R * self.S * self.bytes_per_elem
        if self.op is OpType.POOL:
            return 0
        return self.K * self.C * self.R * self.S * self.bytes_per_elem

    @property
    def in_bytes(self) -> int:
        # input activation footprint (approximate: stride-1 equivalence)
        c_in = self.C
        return c_in * self.Y * self.X * self.bytes_per_elem

    @property
    def out_bytes(self) -> int:
        k_out = self.C if self.op in (OpType.DWCONV, OpType.POOL) else self.K
        return k_out * self.Y * self.X * self.bytes_per_elem


@dataclass(frozen=True)
class GenAIMeta:
    """Autoregressive-generation spec attached to a :class:`ModelGraph`.

    Layers ``[0, prefill_len)`` run once per job (the prompt / prefill
    phase); layers ``[prefill_len, n_layers)`` form ONE decode step and
    repeat once per generated token.  Per-job token counts are stochastic
    (geometric with mean ``token_mean``, capped at ``max_new_tokens``),
    drawn by the simulator on a dedicated RNG stream.  ``max_new_tokens``
    doubles as the degradation-ladder knob: lighter variants carry a
    smaller cap.
    """

    prefill_len: int
    max_new_tokens: int
    token_mean: float


@dataclass(frozen=True)
class ModelGraph:
    """A model as an ordered layer list plus its dynamic-behaviour spec.

    Dynamicity hooks (Section 2.2 of the paper):
      * ``skip_blocks``: [start, end) layer ranges that are skipped with
        probability ``skip_prob`` (SkipNet-style layer skipping).
      * ``exit_points``: (layer_idx, exit_prob) early exits (RAPID-RL /
        BranchyNet-style); inference stops after ``layer_idx`` w.p. prob.
      * ``variants``: lighter weight-sharing Supernet variants (Once-for-All);
        variant 0 is the original (heaviest). Used by Supernet switching.
      * ``genai``: autoregressive prefill/decode spec — the execution path
        repeats the decode segment once per generated token.
    """

    name: str
    layers: tuple[Layer, ...]
    skip_blocks: tuple[tuple[int, int], ...] = ()
    skip_prob: float = 0.0
    exit_points: tuple[tuple[int, float], ...] = ()
    variants: tuple["ModelGraph", ...] = ()
    genai: Optional[GenAIMeta] = None

    @property
    def macs(self) -> int:
        return sum(l.macs for l in self.layers)

    @property
    def weight_bytes(self) -> int:
        return sum(l.weight_bytes for l in self.layers)

    def sample_path(self, rng) -> list[int]:
        """Sample a concrete execution path (list of layer indices)."""
        n = len(self.layers)
        skipped: set[int] = set()
        for (s, e) in self.skip_blocks:
            if rng.random() < self.skip_prob:
                skipped.update(range(s, e))
        path: list[int] = []
        for i in range(n):
            if i in skipped:
                continue
            path.append(i)
            for (exit_idx, p) in self.exit_points:
                if i == exit_idx and rng.random() < p:
                    return path
        return path

    def genai_path(self, n_tokens: int) -> list[int]:
        """Concrete execution path for an autoregressive job emitting
        ``n_tokens``: the prefill segment once, then the decode segment
        repeated per token (layer indices repeat on purpose — every
        consumer gathers per-index, so repetition is well-defined)."""
        g = self.genai
        pl = g.prefill_len
        decode = list(range(pl, len(self.layers)))
        return list(range(pl)) + decode * max(int(n_tokens), 1)

    def worst_path(self) -> list[int]:
        """Longest path (no skips, no early exit) — static-scheduler view.
        For autoregressive graphs: prefill + ``max_new_tokens`` decode
        repetitions, the longest generation the cap admits."""
        if self.genai is not None:
            return self.genai_path(self.genai.max_new_tokens)
        return list(range(len(self.layers)))


@dataclass(frozen=True)
class ModelSpec:
    """One entry of an RTMM scenario (a row of the paper's Table 3)."""

    model: ModelGraph
    fps: float
    depends_on: Optional[str] = None   # name of the upstream model
    trigger_prob: float = 0.5          # P(parent result triggers this model)
    deadline_s: Optional[float] = None  # default: 1/fps
    #: arrival process driving this stream (None = strict legacy periodic).
    #: Either an object implementing the ArrivalProcess protocol of
    #: repro_torch.scenarios.arrivals, or its ``to_config`` dict; the engines
    #: materialize it at setup.  Core stays import-independent of the
    #: scenarios package by treating this as an opaque duck-typed value.
    arrival: Optional[object] = None

    @property
    def period_s(self) -> float:
        return 1.0 / self.fps

    @property
    def deadline(self) -> float:
        return self.deadline_s if self.deadline_s is not None else self.period_s


@dataclass(frozen=True)
class Scenario:
    """A full RTMM workload scenario (Table 3)."""

    name: str
    models: tuple[ModelSpec, ...]

    def model_index(self, name: str) -> int:
        for i, spec in enumerate(self.models):
            if spec.model.name == name:
                return i
        raise KeyError(name)

    def dependents_of(self, name: str) -> list[int]:
        return [i for i, s in enumerate(self.models) if s.depends_on == name]

    def is_chain_tail(self, idx: int) -> bool:
        """True if no other model depends on this one (frame-drop cond. 3)."""
        return not self.dependents_of(self.models[idx].model.name)


class Dataflow(enum.Enum):
    WS = "ws"  # weight stationary  (NVDLA-inspired)
    OS = "os"  # output stationary  (ShiDianNao-inspired)


@dataclass(frozen=True)
class Accelerator:
    """One sub-accelerator of the multi-accelerator system (Table 2)."""

    name: str
    pes: int
    dataflow: Dataflow
    sram_bytes: int = 8 * MiB
    dram_bw: float = 90e9       # bytes/s shared off-chip bandwidth
    clock_hz: float = 700e6

    def split(self, parts: int) -> list["Accelerator"]:
        """Planaria-style fission into equal sub-arrays."""
        assert self.pes % parts == 0
        return [
            replace(self, name=f"{self.name}.{i}", pes=self.pes // parts)
            for i in range(parts)
        ]


def _acc(name: str, pes: int, df: Dataflow) -> Accelerator:
    return Accelerator(name=name, pes=pes, dataflow=df)


#: The eight hardware systems of Table 2 (4K / 8K PEs, homo / hetero).
SYSTEMS: dict[str, tuple[Accelerator, ...]] = {
    "4K_2WS": (_acc("ws0", 2048, Dataflow.WS), _acc("ws1", 2048, Dataflow.WS)),
    "4K_2OS": (_acc("os0", 2048, Dataflow.OS), _acc("os1", 2048, Dataflow.OS)),
    "4K_1WS2OS": (
        _acc("ws0", 2048, Dataflow.WS),
        _acc("os0", 1024, Dataflow.OS),
        _acc("os1", 1024, Dataflow.OS),
    ),
    "4K_1OS2WS": (
        _acc("os0", 2048, Dataflow.OS),
        _acc("ws0", 1024, Dataflow.WS),
        _acc("ws1", 1024, Dataflow.WS),
    ),
    "8K_2WS": (_acc("ws0", 4096, Dataflow.WS), _acc("ws1", 4096, Dataflow.WS)),
    "8K_2OS": (_acc("os0", 4096, Dataflow.OS), _acc("os1", 4096, Dataflow.OS)),
    "8K_1WS2OS": (
        _acc("ws0", 4096, Dataflow.WS),
        _acc("os0", 2048, Dataflow.OS),
        _acc("os1", 2048, Dataflow.OS),
    ),
    "8K_1OS2WS": (
        _acc("os0", 4096, Dataflow.OS),
        _acc("ws0", 2048, Dataflow.WS),
        _acc("ws1", 2048, Dataflow.WS),
    ),
}

HETERO_SYSTEMS = ("4K_1WS2OS", "4K_1OS2WS", "8K_1WS2OS", "8K_1OS2WS")
HOMO_SYSTEMS = ("4K_2WS", "4K_2OS", "8K_2WS", "8K_2OS")
