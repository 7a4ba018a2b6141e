"""Model facade (reference parity: mythril/laser/smt/model.py:6-66 — wraps a
*list* of backend models because the IndependenceSolver returns one model per
independent constraint bucket)."""

from typing import List, Optional, Union

from . import terms as T
from .bitvec import BitVec
from .bool import Bool


class Model:
    """Holds one model per constraint bucket; eval searches them in order."""

    def __init__(self, models: Optional[List] = None):
        self.raw = models or []  # list of solver.core.ModelData

    def decls(self) -> List[str]:
        out = []
        for m in self.raw:
            out.extend(m.bv.keys())
            out.extend(m.bools.keys())
        return out

    def __getitem__(self, name: str):
        for m in self.raw:
            if name in m.bv:
                return m.bv[name]
            if name in m.bools:
                return m.bools[name]
        return None

    def eval(self, expression, model_completion: bool = False):
        """Evaluate a facade expression (or raw term) under the model.

        Returns a concrete BitVec/Bool wrapper, or None when the expression
        is not determined and model_completion is False.
        """
        t = expression.raw if hasattr(expression, "raw") else expression
        last_err = None
        for m in self.raw:
            try:
                v = m.eval_term(t, complete=False)
                return _wrap(t, v)
            except KeyError as e:
                last_err = e
                continue
        if model_completion and self.raw:
            # merge all buckets into a FRESH env, then complete with
            # defaults — ModelData.env() is cached and must never be
            # mutated in place
            bv, arrays, funcs = {}, {}, {}
            for m in self.raw:
                bv.update(m.bv)
                bv.update(m.bools)
                arrays.update(m.arrays)
                funcs.update(m.funcs)
            merged = T.EvalEnv(bv=bv, arrays=arrays, funcs=funcs,
                               complete=True)
            return _wrap(t, T.eval_term(t, merged))
        if model_completion:
            return _wrap(t, T.eval_term(t, T.EvalEnv(complete=True)))
        return None


def _wrap(t: "T.Term", v):
    if t.is_bool:
        return Bool(T.bool_t(bool(v)))
    return BitVec(T.bv_const(v, t.width))
