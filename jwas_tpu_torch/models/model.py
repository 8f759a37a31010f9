"""Model building: R-style model equations -> the mixed-model structure.

Counterpart of jwas_tpu/models/model.py: ModelTerm (:30), RandomEffect
(:52), Model (:65), build_model (:97-201), set_covariate (:225),
set_random (:231-348), outputEBV (:351), outputMCMCsamples (:356),
describe (:368), getMCMCinfo (:400) and the deprecated add_genotypes
(:203), for one equation (single-trait) or several (multi-trait, one a
trait, with a t x t residual covariance) with fixed factors, covariates,
interactions, random effects (i.i.d., pedigree and user-given Vinv groups,
a k x k covariance over their k terms) and at most one genotype category.
Genotypes are passed explicitly (build_model(..., genotypes=geno)).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import scipy.sparse as sp

from jwas_tpu_torch.io.genotypes import Genotypes, VarianceSpec
from jwas_tpu_torch.io.pedigree import Pedigree


@dataclass
class ModelTerm:
    """One term of a model equation, e.g. "y1:A*B" (types.jl:9-47)."""

    trm_str: str                    # "y1:A*B"
    i_model: int                    # 0-based trait index
    trait_name: str
    factors: List[str]              # ["A", "B"] or ["intercept"]
    random_type: str = "fixed"      # fixed | I | V | A
    names: List[str] = field(default_factory=list)   # level names (a "V"
                                    # or "A" term: Vinv's or the pedigree's)
    n_levels: int = 0
    start_pos: int = 0              # column offset in the location design
    X: Optional[sp.csc_matrix] = None
    data: Optional[List[str]] = None   # per-observation level string
    val: Optional[np.ndarray] = None   # per-observation value

    @property
    def n_factors(self) -> int:
        return len(self.factors)


@dataclass
class RandomEffect:
    """A random-effect group (types.jl:86-96): its terms share the levels
    and have the (k, k) covariance G per level."""

    term_array: List[str]           # ["y:ID", "y:dam"]
    G: VarianceSpec
    Vinv: Optional[sp.spmatrix]     # None: the identity ("I")
    names: List[str]                # level names, Vinv's row order
    random_type: str                # "A" | "V" | "I"
    Vinv_factor: Optional[sp.spmatrix] = None   # F with Vinv = F'F (the
                                    # pedigree's hAi; single-step's epsilon:
                                    # hAi's column slice), for the sparse
                                    # location path's joint draw


@dataclass
class Model:
    """The model (the reference's MME struct, types.jl:264-346)."""

    n_models: int
    model_vec: List[str]
    terms: List[ModelTerm]
    term_dict: Dict[str, ModelTerm]
    lhs_vec: List[str]
    R: VarianceSpec
    cov_vec: List[str] = field(default_factory=list)
    random_effects: List[RandomEffect] = field(default_factory=list)
    ped: Optional[Pedigree] = None
    ped_term_vec: List[str] = field(default_factory=list)
    M: List[Genotypes] = field(default_factory=list)
    traits_type: List[str] = field(default_factory=list)
    output_ids: Optional[List[str]] = None
    output_samples_terms: List[str] = field(default_factory=list)
    mme_pos: int = 0
    causal_structure: Optional[np.ndarray] = None
    mcmc_info: object = None            # MCMCOptions captured by runMCMC

    def term_names(self) -> List[str]:
        """'trait:effect:level' in design order (getNames, build_MME.jl:385)."""
        return [f"{trm.trm_str}:{name}" for trm in self.terms for name in trm.names]


def build_model(model_equations: str, R=None, *, df: float = 4.0,
                estimate_variance: bool = True, estimate_scale: bool = False,
                constraint: bool = False, censored_trait: Sequence[str] = (),
                categorical_trait: Sequence[str] = (),
                genotypes: Union[Genotypes, Sequence[Genotypes], None] = None) -> Model:
    """Parse a model equation into a Model (build_MME.jl:42-156).

    model_equations: one equation, e.g. "y = intercept + herd + age + geno",
    or one a line (or ";") for several traits, e.g.
    "y1 = intercept + geno\ny2 = intercept + geno"; every variable is a
    fixed factor unless set_covariate makes it a covariate, "A*B" is an
    interaction, and a name equal to a genotype set's name fits that
    marker set. R: the residual variance's prior mean, a scalar or a t x t
    covariance (default: half the phenotypic variance). censored_trait and
    categorical_trait name the latent traits (build_MME.jl:196-199): a
    censored trait reads its bounds from the columns <name>_l and <name>_u,
    a categorical trait its categories 1..K (binary when K is 2, set by
    runMCMC). More than one genotype category is not ported.
    """
    if not isinstance(model_equations, str) or not model_equations.strip():
        raise ValueError("model equations are wrong; pass e.g. 'y = intercept + age'")
    if estimate_scale:
        raise ValueError("estimate scale for residual variance is not supported")
    eqs = [e.strip() for e in model_equations.replace(";", "\n").splitlines() if e.strip()]
    t = len(eqs)
    R_arr = None
    if R is not None:
        R_arr = np.atleast_2d(np.asarray(R, dtype=np.float64))
        if R_arr.shape != (t, t):
            raise ValueError(f"the residual covariance matrix is not {t}x{t}")
        if np.any(np.linalg.eigvalsh(R_arr) <= 0):
            raise ValueError("the covariance matrix is not positive definite")
    geno_list: List[Genotypes] = []
    if genotypes is not None:
        geno_list = [genotypes] if isinstance(genotypes, Genotypes) else list(genotypes)
    if len(geno_list) > 1:
        raise ValueError(
            f"{len(geno_list)} genotype categories: only one is supported (a "
            f"second would be dropped silently; ROADMAP.md known fault R2)")
    geno_by_name = {g.name: g for g in geno_list}

    lhs_vec: List[str] = []
    terms: List[ModelTerm] = []
    used_genos: List[Genotypes] = []
    for m, eq in enumerate(eqs):
        lhs, rhs = (s.strip() for s in eq.split("="))
        lhs_vec.append(lhs)
        for trm_str in (s.strip() for s in rhs.split("+")):
            base = trm_str.split("*")[-1].strip()
            if base in geno_by_name:
                if geno_by_name[base] not in used_genos:
                    used_genos.append(geno_by_name[base])
                continue
            terms.append(ModelTerm(trm_str=f"{lhs}:{trm_str}", i_model=m,
                                   trait_name=lhs,
                                   factors=[f.strip() for f in trm_str.split("*")]))

    # residual prior: scale/df transform (build_MME.jl:127-134)
    if t == 1:
        R_val = None if R_arr is None else float(R_arr[0, 0])
        df_R, scale_R = df, None if R_val is None else R_val * (df - 2.0) / df
    else:
        R_val, df_R = R_arr, df + t
        scale_R = None if R_arr is None else R_arr * (df - 1.0)
    model = Model(
        n_models=t, model_vec=eqs, terms=terms,
        term_dict={trm.trm_str: trm for trm in terms}, lhs_vec=lhs_vec,
        R=VarianceSpec(val=R_val, df=df_R, scale=scale_R,
                       estimate_variance=estimate_variance,
                       estimate_scale=estimate_scale, constraint=constraint),
        traits_type=["censored" if lhs in censored_trait
                     else "categorical" if lhs in categorical_trait
                     else "continuous" for lhs in lhs_vec],
    )
    for g in used_genos:
        _attach(model, g)
    return model


def _attach(model: Model, g: Genotypes) -> None:
    """Fit the marker set g in the model; with t traits its prior gains t
    degrees of freedom (build_MME.jl:148-152)."""
    if model.n_models != 1:
        g.G.df = g.G.df + model.n_models
    model.M.append(g)


def add_genotypes(model: Model, file, G=None, **kwargs) -> Genotypes:
    """Deprecated shim (readgenotypes.jl:24-47): attach genotypes to an
    existing model. Prefer build_model(..., genotypes=get_genotypes(...))."""
    import warnings

    warnings.warn(
        "add_genotypes is deprecated; pass genotypes=get_genotypes(...) to "
        "build_model instead", DeprecationWarning, stacklevel=2)
    from jwas_tpu_torch.io.genotypes import get_genotypes

    g = file if isinstance(file, Genotypes) else get_genotypes(file, G, **kwargs)
    _attach(model, g)
    return g


def set_covariate(model: Model, *cov_strs: str) -> None:
    """Mark variables as continuous covariates (build_MME.jl:170-176)."""
    for s in cov_strs:
        model.cov_vec.extend(v for v in s.split() if v)


def set_random(model: Model, random_str: str, arg=None, G=None, *, Vinv=None,
               names: Sequence[str] = (), Vinv_factor=None, df: float = 4.0,
               estimate_variance: bool = True, estimate_scale: bool = False,
               constraint: bool = False) -> None:
    """Declare a random-effect group (random_effects.jl:40-54, :93-191):
    set_random(model, "ID dam", ped, G) (pedigree, "A"; A^-1 from ped, its
    factor hAi kept), set_random(model, "litter", G) (i.i.d., "I") or
    set_random(model, "x", G, Vinv=Vi, names=[...]) (user-given Vinv,
    dense or scipy sparse, "V"; Vinv_factor: a sparse F with Vinv = F'F,
    which the sparse location path's joint draw uses in place of a dense
    Cholesky factor). G: the (k, k) covariance of the group's k terms
    (None: the default of runMCMC); its prior has df + k degrees of
    freedom and scale G (df + k - k - 1). The terms "ϵ" and "eps"
    (single-step's imputation residual, added by ssbr_setup) need not be
    in the equations."""
    ped = None
    if isinstance(arg, Pedigree):
        ped = arg
    elif G is None:
        G = arg
    elif arg is not None:
        raise TypeError("second positional argument must be a Pedigree or the variance G")
    if constraint:
        raise ValueError("constraint for variance of random term is not supported")
    if estimate_scale:
        raise ValueError("estimate scale for variance of random term is not supported")
    if ped is not None:
        if model.ped is not None:
            raise ValueError("pedigree information can only be set once")
        model.ped = ped
    G_arr = None
    if G is not None:
        G_arr = np.atleast_2d(np.asarray(G, dtype=np.float64))
        if np.any(np.linalg.eigvalsh(G_arr) <= 0):
            raise ValueError("the covariance matrix is not positive definite")

    term_array: List[str] = []
    for trm in random_str.split():
        found = False
        for m, eq in enumerate(model.model_vec):
            parts = [s.strip() for s in eq.split("=")[1].split("+")]
            if trm in parts or trm in ("ϵ", "eps"):
                term_array.append(f"{model.lhs_vec[m]}:{trm}")
                found = True
        if not found:
            raise ValueError(f"{trm} is not found in model equations")
    k = len(term_array)
    model_terms = [model.term_dict[t] for t in term_array if t in model.term_dict]

    if ped is not None:
        random_type, level_names = "A", list(ped.ids)
        Vinv_factor = ped.a_inverse_factor()
        Vinv_mat = (Vinv_factor.T @ Vinv_factor).tocsc()
        model.ped_term_vec = list(term_array)
    elif Vinv is not None:
        if len(names) == 0:
            raise ValueError("names must be provided together with Vinv")
        level_names = [str(s) for s in names]
        Vinv_mat = sp.csc_matrix(Vinv)
        if Vinv_mat.shape[0] != len(level_names) or len(set(level_names)) != len(level_names):
            raise ValueError("wrong size or duplicated values in Vinv and names")
        random_type = "V"
    else:
        random_type, level_names, Vinv_mat = "I", [], None
    for t in model_terms:
        t.random_type = random_type
        if random_type != "I":
            t.names = list(level_names)
    df_final = df + k
    scale = None if G_arr is None else G_arr * (df_final - k - 1.0)
    if G_arr is not None and k != G_arr.shape[0]:
        raise ValueError(f"dimensions must match: G should be {k}x{k}")
    model.random_effects.append(RandomEffect(
        term_array=list(term_array),
        G=VarianceSpec(val=G_arr, df=df_final, scale=scale,
                       estimate_variance=estimate_variance,
                       estimate_scale=estimate_scale, constraint=constraint),
        Vinv=Vinv_mat, names=level_names, random_type=random_type,
        Vinv_factor=None if Vinv_factor is None else sp.csc_matrix(Vinv_factor)))


def outputEBV(model: Model, ids: Sequence[str]) -> None:
    """Request EBV/PEV output for specific individuals (output.jl:66-69)."""
    model.output_ids = [str(s) for s in ids]


def outputMCMCsamples(model: Model, *trm_strs: str) -> None:
    """Request MCMC sample files for location-parameter terms
    (output.jl:76-93)."""
    for trm_str in trm_strs:
        for m, eq in enumerate(model.model_vec):
            parts = [s.strip() for s in eq.split("=")[1].split("+")]
            if trm_str in parts:
                full = f"{model.lhs_vec[m]}:{trm_str}"
                if full not in model.output_samples_terms:
                    model.output_samples_terms.append(full)


def describe(model: Model) -> None:
    """Print a model summary (the reference's `describe`, JWAS.jl:520-571)."""
    print("A Linear Mixed Model was built using model equations:\n")
    for eq in model.model_vec:
        print(f"  {eq}")
    print("\nModel Information:\n")
    print(f"{'Term':<20}{'C/F':<12}{'F/R':<10}{'nLevels':>8}")
    seen = set()
    for trm in model.terms:
        base = trm.factors[-1]
        term = trm.trm_str.split(":", 1)[1]
        if term in seen:
            continue
        seen.add(term)
        if term == "intercept":
            cf = "factor"
        elif len(trm.factors) > 1:
            cf = "interaction"
        else:
            cf = "covariate" if base in model.cov_vec else "factor"
        fr = "fixed" if trm.random_type == "fixed" else "random"
        print(f"{term:<20}{cf:<12}{fr:<10}{trm.n_levels or '?':>8}")
    for g in model.M:
        print(f"{g.name:<20}{'marker':<12}{'random':<10}{g.n_markers:>8}  "
              f"method={g.method}")
    print()
    if model.mcmc_info is not None and getattr(
            model.mcmc_info, "printout_model_info", True):
        getMCMCinfo(model)


def _fmt(x, digits: int) -> str:
    return np.array2string(np.round(np.atleast_2d(np.asarray(x, dtype=float)), digits))


def getMCMCinfo(model: Model) -> None:
    """Print MCMC and hyper-parameter information (getMCMCinfo,
    JWAS.jl:573-700)."""
    info = model.mcmc_info
    if info is None:
        print("MCMC information is not available\n")
        return
    print("MCMC Information:\n")
    for name in ("chain_length", "burnin", "printout_frequency",
                 "output_samples_frequency", "missing_phenotypes",
                 "update_priors_frequency", "seed", "double_precision",
                 "fast_blocks", "n_chains", "single_step_analysis",
                 "outputEBV", "output_heritability", "output_folder"):
        print(f"{name:<30}{str(getattr(info, name, None)):>24}")
    print(f"{'constraint on residual variance':<30}"
          f"{str(bool(model.R.constraint)):>20}")
    for g in model.M:
        print(f"constraint on marker effect variance for {g.name}: "
              f"{bool(g.G.constraint)}")
    print("\nHyper-parameters Information:\n")
    if model.R.val is not None:
        print(f"{'residual variances:':<35}{_fmt(model.R.val, 3)}")
    for g in model.M:
        print(f"\nGenomic Information ({g.name}):\n")
        print(f"{'method':<30}{g.method:>24}")
        print(f"{'nMarkers':<30}{g.n_markers:>24}")
        print(f"{'nObs':<30}{g.n_obs:>24}")
        print(f"{'estimatePi':<30}{str(bool(g.estimate_pi)):>24}")
        if g.genetic_variance.val is not None:
            print(f"{'genetic variance':<30}{_fmt(g.genetic_variance.val, 4):>24}")
        if g.G.val is not None:
            print(f"{'marker effect variance':<30}{_fmt(g.G.val, 6):>24}")
        print(f"{'pi':<30}{str(g.pi):>24}")
