"""The paper's own workloads (§6): logistic regression and non-convex
robust linear regression on LIBSVM-shaped data.

A copy of the reference's ``configs/paper_workloads.py`` (the port imports
nothing of ``repro``).  Offline, the data are synthetic twins of a9a
(d=123, n≈32k, 70/30 split) and w8a (d=300, n_train≈50k, n_test≈15k); see
:mod:`repro_torch.data.synthetic`.
"""
import dataclasses


@dataclasses.dataclass(frozen=True)
class PaperWorkload:
    name: str
    problem: str          # "logistic" | "robust_regression"
    dim: int
    n_train: int
    n_test: int
    m_workers: int = 20   # paper partitions data over 20 machines
    reg_lambda: float = 1.0
    M: float = 10.0
    eta: float = 1.0


A9A_LOGISTIC = PaperWorkload("a9a-logistic", "logistic", 123, 22400, 9600)
A9A_ROBUST = PaperWorkload("a9a-robust", "robust_regression", 123, 22400, 9600)
W8A_LOGISTIC = PaperWorkload("w8a-logistic", "logistic", 300, 49749, 14951)
W8A_ROBUST = PaperWorkload("w8a-robust", "robust_regression", 300, 49749, 14951)

PAPER_WORKLOADS = {
    w.name: w for w in (A9A_LOGISTIC, A9A_ROBUST, W8A_LOGISTIC, W8A_ROBUST)
}
