"""Scenario registry: named scenario factories, Table 3 included.

The five RTMM scenarios of the paper's Table 3 are registered here as
plain :class:`ScenarioBuilder` instances — no longer special-cased code
paths — next to whatever scenarios users register themselves:

    @register("My_Factory_Floor")
    def _floor(cascade_prob: float = 0.5) -> ScenarioBuilder:
        return (ScenarioBuilder("My_Factory_Floor")
                .model("ssd_mnv2", fps=30, name="det", kwargs={"res": 512})
                .model("sosnet", fps=60, name="track",
                       depends_on="det", trigger_prob=cascade_prob))

``repro_torch.core.workloads`` keeps its historical ``build_scenario`` /
``SCENARIOS`` API by delegating to this module.
"""
from __future__ import annotations

from typing import Callable

from .builder import ScenarioBuilder, ScenarioError
from ..core.types import Scenario

_FACTORIES: dict[str, Callable[..., ScenarioBuilder]] = {}


def register(name: str):
    """Decorator registering a ``(**kw) -> ScenarioBuilder`` factory."""
    def deco(fn: Callable[..., ScenarioBuilder]):
        _FACTORIES[name] = fn
        return fn
    return deco


def names() -> tuple[str, ...]:
    return tuple(sorted(_FACTORIES))


def get(name: str, **kw) -> ScenarioBuilder:
    try:
        fac = _FACTORIES[name]
    except KeyError:
        raise ScenarioError(
            f"unknown scenario {name!r}; registered: {', '.join(names())}"
        ) from None
    return fac(**kw)


def build(name: str, **kw) -> Scenario:
    return get(name, **kw).build()


# ---------------------------------------------------------------------------
# Table 3 — the paper's five RTMM scenarios as registry instances
# ---------------------------------------------------------------------------


@register("VR_Gaming")
def _vr_gaming(cascade_prob: float = 0.5) -> ScenarioBuilder:
    return (ScenarioBuilder("VR_Gaming")
            .model("fbnet_c", fps=60, name="gaze_fbnet_c")
            .model("ssd_mnv2", fps=30, name="hand_det_ssd",
                   kwargs={"res": 640})
            .model("handpose", fps=30, name="pose_handpose",
                   kwargs={"res": 320}, depends_on="hand_det_ssd",
                   trigger_prob=cascade_prob)
            .model("ofa", fps=30, name="ctx_ofa")
            .model("kws_res8", fps=15, name="kws_res8")
            .model("gnmt", fps=15, name="translate_gnmt",
                   depends_on="kws_res8", trigger_prob=cascade_prob))


@register("AR_Call")
def _ar_call(cascade_prob: float = 0.5) -> ScenarioBuilder:
    return (ScenarioBuilder("AR_Call")
            .model("kws_res8", fps=15, name="kws_res8")
            .model("gnmt", fps=15, name="translate_gnmt",
                   depends_on="kws_res8", trigger_prob=cascade_prob)
            .model("skipnet", fps=30, name="ctx_skipnet",
                   kwargs={"res": 448}))


@register("Drone_Outdoor")
def _drone_outdoor(cascade_prob: float = 0.5) -> ScenarioBuilder:
    del cascade_prob  # no cascaded pipeline in this scenario (Table 3)
    return (ScenarioBuilder("Drone_Outdoor")
            .model("ssd_mnv2", fps=30, name="objdet_ssd", kwargs={"res": 640})
            .model("trailnet", fps=60, name="nav_trailnet")
            .model("sosnet", fps=60, name="vo_sosnet",
                   kwargs={"patches": 144}))


@register("Drone_Indoor")
def _drone_indoor(cascade_prob: float = 0.5) -> ScenarioBuilder:
    del cascade_prob
    return (ScenarioBuilder("Drone_Indoor")
            .model("ssd_mnv2", fps=30, name="objdet_ssd", kwargs={"res": 640})
            .model("rapid_rl", fps=60, name="nav_rapid_rl")
            .model("sosnet", fps=60, name="obst_sosnet",
                   kwargs={"patches": 144})
            .model("googlenet_car", fps=60, name="car_googlenet"))


@register("AR_Social")
def _ar_social(cascade_prob: float = 0.5) -> ScenarioBuilder:
    return (ScenarioBuilder("AR_Social")
            .model("focal_depth", fps=30, name="depth_focal")
            .model("ed_tcn", fps=30, name="action_ed_tcn")
            .model("ssd_mnv2", fps=30, name="face_det_ssd",
                   kwargs={"res": 640})
            .model("vgg_voxceleb", fps=30, name="verif_vggvox",
                   depends_on="face_det_ssd", trigger_prob=cascade_prob)
            .model("ofa", fps=30, name="ctx_ofa"))


TABLE3 = ("VR_Gaming", "AR_Call", "Drone_Outdoor", "Drone_Indoor",
          "AR_Social")


# ---------------------------------------------------------------------------
# Generative-AI scenarios (autoregressive chat_llm job family)
# ---------------------------------------------------------------------------


@register("Chat_Assistant")
def _chat_assistant(cascade_prob: float = 0.5) -> ScenarioBuilder:
    """Mixed interactive assistant: an autoregressive chat head sharing
    the device with a vision pipeline — the paper's dynamic-workload
    stress case for token-level preemption (the fixed-deadline vision
    stream must be able to preempt the chat decode loop mid-generation).
    """
    return (ScenarioBuilder("Chat_Assistant")
            .add_genai_stream(fps=4, name="chat_llm",
                              kwargs={"max_new_tokens": 24,
                                      "token_mean": 10.0})
            .model("ssd_mnv2", fps=30, name="cam_det_ssd",
                   kwargs={"res": 640})
            .model("handpose", fps=30, name="pose_handpose",
                   kwargs={"res": 320}, depends_on="cam_det_ssd",
                   trigger_prob=cascade_prob)
            .model("kws_res8", fps=15, name="kws_res8"))


@register("Voice_Agent")
def _voice_agent(cascade_prob: float = 0.5) -> ScenarioBuilder:
    """Speech-triggered agent: keyword spotting cascades into an
    autoregressive response generator, next to a periodic context model.
    Exercises genai jobs *as cascade tails* (triggered arrivals)."""
    return (ScenarioBuilder("Voice_Agent")
            .model("kws_res8", fps=15, name="kws_res8")
            .add_genai_stream(fps=15, name="reply_llm",
                              kwargs={"max_new_tokens": 16,
                                      "token_mean": 6.0},
                              depends_on="kws_res8",
                              trigger_prob=cascade_prob)
            .model("fbnet_c", fps=30, name="ctx_fbnet_c"))
