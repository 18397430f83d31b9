"""Synthetic closed-world corpora.

The paper fine-tunes on Alpaca (instructions) and AG-News (4-class topic
classification).  Offline we synthesize structurally equivalent corpora over
a small token vocabulary with *known latent structure*, which is what lets
reward models be trained and evaluated without human feedback:

* ``InstructionCorpus`` — instruction/response pairs.  Tokens are grouped in
  topic clusters; a HELPFUL response reuses the instruction's topic cluster;
  an unhelpful one drifts off-topic.  A designated *sensitive* token range
  models private information: responses containing it are UNSAFE.  Ground-
  truth helpfulness/safety scores are emitted with each sample (used to rank
  pairs when training the reward models, standing in for human rankers).
* ``ClassificationCorpus`` — AG-News-like: 4 classes, each with a peaked
  token distribution; documents are sampled from a class-conditional mixture.

The port's copy of ``repro.data.synthetic`` (numpy only); its test holds it against
the original draw for draw.
"""
from __future__ import annotations

import dataclasses

import numpy as np

VOCAB = 512
SPECIAL = {"bos": 0, "eos": 1, "pad": 2, "instr": 3, "resp": 4, "mask": 5}
N_TOPICS = 8
TOPIC_SIZE = 48
TOPIC_BASE = 16                       # topic t owns [base+t*size, base+(t+1)*size)
SENSITIVE_RANGE = (400, 450)          # unsafe tokens


def topic_tokens(t: int) -> np.ndarray:
    lo = TOPIC_BASE + t * TOPIC_SIZE
    return np.arange(lo, lo + TOPIC_SIZE)


def helpfulness_score(instr_topic: int, response: np.ndarray) -> float:
    """Fraction of response tokens inside the instruction's topic cluster."""
    toks = topic_tokens(instr_topic)
    if len(response) == 0:
        return 0.0
    return float(np.isin(response, toks).mean())


def safety_score(response: np.ndarray) -> float:
    """1 - fraction of sensitive tokens."""
    if len(response) == 0:
        return 1.0
    lo, hi = SENSITIVE_RANGE
    return float(1.0 - ((response >= lo) & (response < hi)).mean())


@dataclasses.dataclass
class InstructionCorpus:
    seq_len: int = 64
    prompt_len: int = 16
    seed: int = 0

    def sample(self, n: int, *, topic_probs=None, helpful_p: float = 0.5,
               unsafe_p: float = 0.3, rng=None):
        """Returns dict of arrays: tokens (n, seq_len), prompt_len, topic,
        help_score, safe_score, mask (response positions)."""
        rng = rng or np.random.RandomState(self.seed)
        if topic_probs is None:
            topic_probs = np.ones(N_TOPICS) / N_TOPICS
        toks = np.full((n, self.seq_len), SPECIAL["pad"], np.int32)
        topics = rng.choice(N_TOPICS, size=n, p=topic_probs)
        helps = np.zeros(n, np.float32)
        safes = np.zeros(n, np.float32)
        mask = np.zeros((n, self.seq_len), np.float32)
        for i in range(n):
            t = topics[i]
            tt = topic_tokens(t)
            prompt = np.concatenate([
                [SPECIAL["bos"], SPECIAL["instr"]],
                rng.choice(tt, self.prompt_len - 3), [SPECIAL["resp"]]])
            resp_len = self.seq_len - self.prompt_len - 1
            helpful = rng.rand() < helpful_p
            pool = tt if helpful else topic_tokens(int(rng.choice(N_TOPICS)))
            resp = rng.choice(pool, resp_len).astype(np.int64)
            if rng.rand() < unsafe_p:
                k = max(1, resp_len // 4)
                pos_s = rng.choice(resp_len, k, replace=False)
                resp[pos_s] = rng.randint(*SENSITIVE_RANGE, size=k)
            seq = np.concatenate([prompt, resp, [SPECIAL["eos"]]])
            toks[i, :len(seq)] = seq
            mask[i, self.prompt_len:len(seq)] = 1.0
            helps[i] = helpfulness_score(t, resp)
            safes[i] = safety_score(resp)
        return {"tokens": toks, "topic": topics, "help": helps,
                "safe": safes, "mask": mask,
                "prompt_len": self.prompt_len}


@dataclasses.dataclass
class ClassificationCorpus:
    n_classes: int = 4
    seq_len: int = 32
    seed: int = 0
    skew: float = 0.55      # probability mass on the class's own cluster
    class_offset: int = 0   # classes use topics [offset, offset+n_classes)
                            # (pre-training uses a disjoint topic range so the
                            # downstream task requires genuine fine-tuning)

    def sample(self, n: int, *, class_probs=None, rng=None):
        rng = rng or np.random.RandomState(self.seed)
        if class_probs is None:
            class_probs = np.ones(self.n_classes) / self.n_classes
        labels = rng.choice(self.n_classes, size=n, p=class_probs)
        toks = np.zeros((n, self.seq_len), np.int32)
        for i in range(n):
            c = labels[i]
            own = topic_tokens(self.class_offset + c)
            other_cls = int((c + 1 + rng.randint(self.n_classes - 1))
                            % self.n_classes)
            other = topic_tokens(self.class_offset + other_cls)
            use_own = rng.rand(self.seq_len - 1) < self.skew
            body = np.where(use_own, rng.choice(own, self.seq_len - 1),
                            rng.choice(other, self.seq_len - 1))
            toks[i] = np.concatenate([[SPECIAL["bos"]], body])
        return {"tokens": toks, "label": labels.astype(np.int32)}
