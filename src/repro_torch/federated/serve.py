"""Federated posterior serving: answer ``q(Z_L | Z_G)`` queries from a checkpoint.

The port of ``repro.federated.serve``. Training ends with the posterior
split across the privacy boundary: the server's ``q_{η_G}(Z_G)`` and one
private ``q_{η_{L_j}}(Z_{L_j} | Z_G)`` per silo. :class:`Posterior` turns a
saved run (:meth:`repro_torch.federated.api.Experiment.save`, by either
package) into a query endpoint:

  * :meth:`Posterior.global_sample` draws from ``q_{η_G}(Z_G)``;
  * :meth:`Posterior.sample` draws joint ``(Z_G, Z_{L_j})`` for one silo
    through the training path's ``SFVIProblem.sample_posterior``
    (conditional families condition on the drawn ``Z_G``);
  * :meth:`Posterior.predict` averages the model's ``predict`` hook over
    posterior draws;
  * :meth:`Posterior.answer_batch` groups queries by (kind, silo) and serves
    each group with ONE ``num_samples = Σ n`` draw, sliced in request order.

Every query is deterministic in its ``seed``: its draws come from
``generator((_SERVE_SALT + seed, silo + 1))`` on the serving device, so
two replicas of one checkpoint answer bit for bit alike. Each method also
takes injected ``eps = (eps_G, eps_L)`` instead. Runs on ``cuda`` unless
given ``device="cpu"`` (``--device cpu``).

CLI::

    python -m repro_torch.federated.serve --ckpt-dir runs/demo --silo 0 --n 3
    python -m repro_torch.federated.serve --ckpt-dir runs/demo --global-sample 5
    python -m repro_torch.federated.serve --ckpt-dir runs/demo \\
        --queries '[{"kind": "sample", "silo": 1, "n": 2}]'
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.func import vmap

from repro_torch.device import generator
from repro_torch.tree import tree_map

PyTree = Any
Eps = Tuple[torch.Tensor, Optional[torch.Tensor]]

# Salt of the serving draw stream (the reference's), apart from training's
# round streams and the population / latency salts.
_SERVE_SALT = 0x53E7


@dataclasses.dataclass(frozen=True)
class Query:
    """One serving request: ``kind`` is ``"sample"`` (joint draws for
    ``silo``), ``"global_sample"`` (Z_G only; ``silo`` ignored) or
    ``"predict"`` (the posterior-predictive output for inputs ``x`` at
    ``silo``, averaged over ``n`` draws)."""

    kind: str
    silo: Optional[int] = None
    n: int = 1
    x: Optional[Any] = None

    def __post_init__(self):
        if self.kind not in ("sample", "global_sample", "predict"):
            raise ValueError(f"unknown query kind {self.kind!r}")
        if self.n < 1:
            raise ValueError(f"n must be >= 1, got {self.n}")
        if self.kind != "global_sample" and self.silo is None:
            raise ValueError(f"{self.kind!r} queries need a silo index")
        if self.kind == "predict" and self.x is None:
            raise ValueError("predict queries need inputs x")

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> Query:
        x = d.get("x")
        return cls(kind=d["kind"], silo=d.get("silo"), n=d.get("n", 1),
                   x=None if x is None else torch.as_tensor(np.asarray(x, np.float32)))


class Posterior:
    """A checkpointed federated posterior, ready to answer queries.

    Wraps a restored :class:`~repro_torch.federated.api.Experiment`: build
    it with :meth:`from_checkpoint`, or as ``Posterior(exp)`` to serve a
    live experiment's state.
    """

    def __init__(self, experiment):
        self.experiment = experiment
        self.server = experiment.server
        self.problem = self.server.problem

    @classmethod
    def from_checkpoint(cls, directory: str, step: Optional[int] = None, *,
                        device=None) -> Posterior:
        """Restore the latest (or ``step``) checkpoint under ``directory``."""
        from repro_torch.federated.api import Experiment

        return cls(Experiment.resume(directory, step=step, device=device))

    # -- state accessors -----------------------------------------------------

    @property
    def num_silos(self) -> int:
        """Live silos (a population checkpoint restores mid-roster)."""
        return self.server.J

    @property
    def round(self) -> int:
        return self.experiment.round

    def eta_row(self, silo: int) -> PyTree:
        """Silo ``silo``'s private η_{L_j} (None for a global-only model)."""
        if not 0 <= silo < self.server.J:
            raise IndexError(
                f"silo {silo} out of range: checkpoint serves {self.server.J} silos")
        if not self.problem.model.has_local:
            return None
        return tree_map(lambda x: x[silo], self.server.state["eta_L"])

    # -- sampling ------------------------------------------------------------

    def _draws(self, seed: int, silo: int, eps: Optional[Eps]):
        """The injected ``(eps_G, eps_L)``, or the query's generator (silo -1:
        the global stream)."""
        if eps is not None:
            dev = self.server.device
            return tuple(None if e is None else e.to(dev) for e in eps)
        return generator((_SERVE_SALT + seed, silo + 1), self.server.device)

    @torch.no_grad()
    def global_sample(self, n: int = 1, seed: int = 0,
                      eps: Optional[Eps] = None) -> torch.Tensor:
        """``n`` draws of Z_G from ``q_{η_G}``: shape ``(n, d_G)``."""
        return self.problem.sample_posterior(
            self.server.state["eta_G"], None, self._draws(seed, -1, eps),
            num_samples=int(n))[0]

    @torch.no_grad()
    def sample(self, silo: int, n: int = 1, seed: int = 0,
               eps: Optional[Eps] = None) -> Dict[str, Optional[torch.Tensor]]:
        """``n`` joint draws for ``silo``: ``{"z_G": (n, d_G), "z_L": (n, d_L)}``;
        ``z_L`` is None for global-only models."""
        eta_L = self.eta_row(silo)
        z_G, z_L = self.problem.sample_posterior(
            self.server.state["eta_G"], eta_L, self._draws(seed, silo, eps),
            num_samples=int(n))
        return {"z_G": z_G, "z_L": z_L}

    @torch.no_grad()
    def predict(self, silo: int, x, n: int = 8, seed: int = 0,
                eps: Optional[Eps] = None) -> torch.Tensor:
        """The model's ``predict(θ, Z_G, Z_{L_silo}, x)`` averaged over ``n``
        joint posterior draws; raises for a model without the hook."""
        model = self.problem.model
        if model.predict is None:
            raise ValueError(
                f"model {model.name!r} has no predict hook; only sample/global_sample "
                f"queries are servable")
        eta_L = self.eta_row(silo)
        x = torch.as_tensor(x, device=self.server.device)
        theta = self.server.state["theta"]
        z_G, z_L = self.problem.sample_posterior(
            self.server.state["eta_G"], eta_L, self._draws(seed, silo, eps),
            num_samples=int(n))
        if z_L is None:
            out = vmap(lambda zg: model.predict(theta, zg, None, x))(z_G)
        else:
            out = vmap(lambda zg, zl: model.predict(theta, zg, zl, x))(z_G, z_L)
        return torch.mean(out, dim=0)

    # -- request batching ----------------------------------------------------

    def answer_batch(self, queries: Sequence[Query], seed: int = 0) -> List[Any]:
        """Serve ``queries`` in request order, one draw per (kind, silo) group.

        The ``sample`` / ``global_sample`` queries of a group are contiguous
        slices of one ``num_samples = Σ n`` draw; ``predict`` queries take
        one call each (their ``x`` differ).
        """
        groups: Dict[Tuple[str, int], List[int]] = {}
        for i, q in enumerate(queries):
            silo = -1 if q.kind == "global_sample" else int(q.silo)
            groups.setdefault((q.kind, silo), []).append(i)
        answers: List[Any] = [None] * len(queries)
        for (kind, silo), idxs in groups.items():
            if kind == "predict":
                for i in idxs:
                    q = queries[i]
                    answers[i] = self.predict(silo, q.x, n=q.n, seed=seed)
                continue
            total = sum(queries[i].n for i in idxs)
            if kind == "global_sample":
                batch = {"z_G": self.global_sample(total, seed=seed), "z_L": None}
            else:
                batch = self.sample(silo, total, seed=seed)
            off = 0
            for i in idxs:
                n = queries[i].n
                answers[i] = {k: None if v is None else v[off:off + n]
                              for k, v in batch.items()}
                off += n
        return answers


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def _jsonable(x):
    if x is None:
        return None
    if isinstance(x, dict):
        return {k: _jsonable(v) for k, v in x.items()}
    return x.detach().cpu().tolist()


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.federated.serve",
        description="Answer q(Z_L|Z_G) queries from a federated checkpoint.")
    ap.add_argument("--ckpt-dir", required=True, metavar="DIR",
                    help="checkpoint directory written by Experiment.save")
    ap.add_argument("--step", type=int, default=None,
                    help="checkpoint step (default: latest)")
    ap.add_argument("--silo", type=int, default=None,
                    help="serve n joint (Z_G, Z_L) draws for this silo")
    ap.add_argument("--n", type=int, default=1,
                    help="draws per query (with --silo / --global-sample)")
    ap.add_argument("--global-sample", type=int, default=None, metavar="N",
                    help="serve N draws of Z_G from q(Z_G)")
    ap.add_argument("--queries", default=None, metavar="JSON",
                    help='batched request list, e.g. \'[{"kind": "sample", "silo": 0, '
                         '"n": 2}]\', served with one draw per (kind, silo) group')
    ap.add_argument("--seed", type=int, default=0,
                    help="query seed (same seed -> bit-identical answers)")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' for the CPU)")
    args = ap.parse_args(argv)

    post = Posterior.from_checkpoint(args.ckpt_dir, step=args.step, device=args.device)
    out: Dict[str, Any] = {"round": post.round, "num_silos": post.num_silos}
    if args.queries is not None:
        qs = [Query.from_dict(d) for d in json.loads(args.queries)]
        out["answers"] = [_jsonable(a) for a in post.answer_batch(qs, seed=args.seed)]
    elif args.global_sample is not None:
        out["z_G"] = _jsonable(post.global_sample(args.global_sample, seed=args.seed))
    elif args.silo is not None:
        out["answer"] = _jsonable(post.sample(args.silo, args.n, seed=args.seed))
    else:
        ap.error("one of --silo, --global-sample or --queries is required")
    json.dump(out, sys.stdout)
    sys.stdout.write("\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
