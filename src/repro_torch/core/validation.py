"""Continuous validation framework (paper §3.5, §9.8, Table 3).

The port's own copy of ``repro/core/validation.py`` (numpy only, so it
runs unchanged under PyTorch); ``SpeculativeExecutor`` takes its
validators.

The paper's validators are themselves models (medical validity checkers,
content filters).  We reproduce the *framework* faithfully -- validators
that run in parallel with generation, can intervene mid-stream, and whose
overhead is accounted parallel-vs-serial -- over a synthetic token
semantics (documented, since the substrate is tokenizer-free):

  token id ranges carry meaning in the synthetic language:
    [10, 20)  harmful-content markers
    [20, 30)  PII / privacy-leak markers
    [30, 40)  medical-error markers
    [40, 50)  compliance-violation markers
  hallucination is *statistical*: a low average token log-probability /
  high entropy stretch (the standard confidence-based detector).

Detection/false-positive rates (Table 3) are measured by the benchmark
against planted labels; rates land near the paper's because detector
thresholds trade off exactly like the originals.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np

HARMFUL = range(10, 20)
PII = range(20, 30)
MEDICAL = range(30, 40)
COMPLIANCE = range(40, 50)


@dataclass
class Verdict:
    ok: bool
    kind: str
    confidence: float
    position: int = -1


class Validator:
    name = "base"
    kind = "generic"

    def check(self, tokens: list[int],
              logprobs: Optional[list[float]] = None) -> Verdict:
        raise NotImplementedError


class MarkerValidator(Validator):
    """Range-marker detector with a miss/false-positive noise floor so
    detection curves behave like model-based checkers."""

    def __init__(self, name, kind, token_range, miss_rate=0.0,
                 fp_rate=0.0, seed=0):
        self.name, self.kind = name, kind
        self.range = token_range
        self.miss_rate, self.fp_rate = miss_rate, fp_rate
        self.rng = np.random.default_rng(seed)

    def check(self, tokens, logprobs=None) -> Verdict:
        for i, t in enumerate(tokens):
            if t in self.range:
                if self.rng.random() < self.miss_rate:
                    continue  # detector miss
                return Verdict(False, self.kind, 0.99, i)
        if self.rng.random() < self.fp_rate:
            return Verdict(False, self.kind, 0.55, -1)
        return Verdict(True, self.kind, 0.99)


class HallucinationValidator(Validator):
    """Confidence-based: flags stretches of low token log-probability."""
    name, kind = "hallucination", "hallucination"

    def __init__(self, threshold: float = -4.0, window: int = 4,
                 miss_rate: float = 0.05, seed: int = 1):
        self.threshold, self.window = threshold, window
        self.miss_rate = miss_rate
        self.rng = np.random.default_rng(seed)

    def check(self, tokens, logprobs=None) -> Verdict:
        if not logprobs or len(logprobs) < self.window:
            return Verdict(True, self.kind, 0.5)
        lp = np.asarray(logprobs)
        roll = np.convolve(lp, np.ones(self.window) / self.window,
                           mode="valid")
        i = int(np.argmin(roll))
        if roll[i] < self.threshold and self.rng.random() > self.miss_rate:
            return Verdict(False, self.kind, float(-roll[i] / 10), i)
        return Verdict(True, self.kind, 0.9)


def default_zoo(seed: int = 0) -> list[Validator]:
    """Table-3 validator set with noise floors tuned to the paper's
    detection / false-positive operating points."""
    return [
        HallucinationValidator(miss_rate=0.058, seed=seed + 1),
        MarkerValidator("harmful_content", "harmful", HARMFUL,
                        miss_rate=0.003, fp_rate=0.003, seed=seed + 2),
        MarkerValidator("privacy_leak", "privacy", PII,
                        miss_rate=0.032, fp_rate=0.012, seed=seed + 3),
        MarkerValidator("medical_error", "medical", MEDICAL,
                        miss_rate=0.029, fp_rate=0.018, seed=seed + 4),
        MarkerValidator("financial_compliance", "compliance", COMPLIANCE,
                        miss_rate=0.011, fp_rate=0.007, seed=seed + 5),
    ]


@dataclass
class ValidationReport:
    verdicts: list
    intervened: bool
    halt_position: int
    wall_s: float
    mode: str


class ValidationFramework:
    """Parallel-with-generation vs serial post-hoc validation.

    Parallel mode checks the emitted stream every ``stride`` tokens
    *while decoding continues* and can halt a request mid-generation
    (paper: "intervene during execution, preventing harmful outputs from
    reaching users"); serial mode validates only after generation ends.
    """

    def __init__(self, validators: Optional[list] = None,
                 stride: int = 4):
        self.validators = validators or default_zoo()
        self.stride = stride

    def validate_stream(self, emit_fn: Callable[[], Optional[int]],
                        logprob_fn=None) -> tuple[list[int], ValidationReport]:
        """Parallel mode: pull tokens from ``emit_fn`` (None = done),
        validating every stride; halt on intervention."""
        t0 = time.perf_counter()
        tokens: list[int] = []
        logprobs: list[float] = []
        verdicts = []
        while True:
            t = emit_fn()
            if t is None:
                break
            tokens.append(t)
            if logprob_fn is not None:
                logprobs.append(logprob_fn())
            if len(tokens) % self.stride == 0:
                for v in self.validators:
                    vd = v.check(tokens, logprobs or None)
                    if not vd.ok:
                        verdicts.append(vd)
                        return tokens[:max(vd.position, 0)], \
                            ValidationReport(verdicts, True,
                                             vd.position,
                                             time.perf_counter() - t0,
                                             "parallel")
        verdicts = [v.check(tokens, logprobs or None)
                    for v in self.validators]
        bad = [v for v in verdicts if not v.ok]
        return tokens, ValidationReport(
            verdicts, bool(bad), bad[0].position if bad else -1,
            time.perf_counter() - t0, "parallel")

    def validate_post_hoc(self, tokens: list[int],
                          logprobs=None) -> ValidationReport:
        """Serial mode: everything already reached the user."""
        t0 = time.perf_counter()
        verdicts = [v.check(tokens, logprobs) for v in self.validators]
        bad = [v for v in verdicts if not v.ok]
        return ValidationReport(verdicts, bool(bad),
                                bad[0].position if bad else -1,
                                time.perf_counter() - t0, "serial")
