// K7 and K8 with a per-marker pattern prior: log_pi (nblocks, b, 2^t), one
// row a marker (2-trait annotated BayesC's tree-probit prior,
// jwas_tpu/ops/annotations.py::anno_bayesc_mt_update, taken by
// jwas_tpu/ops/multitrait.py:179-193 and :319-333 as a (B, S) log_pi), for
// t = 2..4. The kernels are mt_inner_rounds.cu's, instantiated with kPM;
// this translation unit holds them so that nvcc builds them beside the
// global prior's, in parallel (_build.py). Entry points
// jt_mt_inner_rounds_{I,II}_pm[_f64], with the arguments of
// jt_mt_inner_rounds_{I,II}.
#define JT_MT_PER_MARKER_PRIOR
#include "mt_inner_rounds.cu"
