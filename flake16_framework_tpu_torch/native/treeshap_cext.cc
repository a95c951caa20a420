// The host Tree SHAP baseline: a copy of the JAX package's C++ module
// (its native/treeshap_cext.cc, whose code it keeps line for line), the
// compiled equivalent of shap.TreeExplainer's C extension (shap 0.40,
// feature_perturbation="tree_path_dependent").
//
// Implements the classic per-sample recursive EXTEND/UNWIND algorithm
// (Lundberg et al., "Consistent Individualized Feature Attribution for Tree
// Ensembles", Algorithm 2) as the reference stack executes it: scalar
// recursion per (sample, tree), O(L * D^2) per pair, in f64. Semantics match
// tests/ref_treeshap.py (the vectorized numpy oracle); the port's tests hold
// it against that oracle, against the JAX package's module and against the
// port's Tree SHAP (tests/test_torch_native_treeshap.py).
//
//   forest_shap_class0(left, right, feature, threshold, value01, x, phi,
//                      T, M, S, F) -> None
//     left/right/feature: int32 [T, M] child ids / split features (<0 leaf)
//     threshold:          float64 [T, M]
//     value01:            float64 [T, M, 2] cover-weighted class counts
//     x:                  float64 [S, F]
//     phi (out, writable) float64 [S, F] — MEAN class-0 SHAP over the T
//                         trees (leaf value = value01[m,0] / cover[m])
//
// Built at first use by native/__init__.py (g++, CPython C API) into the
// package's _build/; a failed build raises there. Read through
// native/baseline.py::forest_shap_class0_cext.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct PathElement {
  int feature_index;
  double zero_fraction;
  double one_fraction;
  double pweight;
};

void extend_path(PathElement *unique_path, int unique_depth,
                 double zero_fraction, double one_fraction,
                 int feature_index) {
  unique_path[unique_depth].feature_index = feature_index;
  unique_path[unique_depth].zero_fraction = zero_fraction;
  unique_path[unique_depth].one_fraction = one_fraction;
  unique_path[unique_depth].pweight = unique_depth == 0 ? 1.0 : 0.0;
  for (int i = unique_depth - 1; i >= 0; --i) {
    unique_path[i + 1].pweight += one_fraction * unique_path[i].pweight *
                                  (i + 1.0) / (unique_depth + 1.0);
    unique_path[i].pweight = zero_fraction * unique_path[i].pweight *
                             (unique_depth - i) / (unique_depth + 1.0);
  }
}

void unwind_path(PathElement *unique_path, int unique_depth, int path_index) {
  const double one_fraction = unique_path[path_index].one_fraction;
  const double zero_fraction = unique_path[path_index].zero_fraction;
  double next_one_portion = unique_path[unique_depth].pweight;
  for (int i = unique_depth - 1; i >= 0; --i) {
    if (one_fraction != 0) {
      const double tmp = unique_path[i].pweight;
      unique_path[i].pweight = next_one_portion * (unique_depth + 1.0) /
                               ((i + 1.0) * one_fraction);
      next_one_portion = tmp - unique_path[i].pweight * zero_fraction *
                                   (unique_depth - i) / (unique_depth + 1.0);
    } else {
      unique_path[i].pweight = (unique_path[i].pweight * (unique_depth + 1.0)) /
                               (zero_fraction * (unique_depth - i));
    }
  }
  for (int i = path_index; i < unique_depth; ++i) {
    unique_path[i].feature_index = unique_path[i + 1].feature_index;
    unique_path[i].zero_fraction = unique_path[i + 1].zero_fraction;
    unique_path[i].one_fraction = unique_path[i + 1].one_fraction;
  }
}

double unwound_path_sum(const PathElement *unique_path, int unique_depth,
                        int path_index) {
  const double one_fraction = unique_path[path_index].one_fraction;
  const double zero_fraction = unique_path[path_index].zero_fraction;
  double next_one_portion = unique_path[unique_depth].pweight;
  double total = 0;
  for (int i = unique_depth - 1; i >= 0; --i) {
    if (one_fraction != 0) {
      const double tmp = next_one_portion * (unique_depth + 1.0) /
                         ((i + 1.0) * one_fraction);
      total += tmp;
      next_one_portion = unique_path[i].pweight -
                         tmp * zero_fraction * (unique_depth - i) /
                             (unique_depth + 1.0);
    } else {
      total += (unique_path[i].pweight / zero_fraction) /
               ((unique_depth - i) / (unique_depth + 1.0));
    }
  }
  return total;
}

struct Tree {
  const int32_t *left;
  const int32_t *right;
  const int32_t *feature;
  const double *threshold;
  const double *value01;  // [M, 2]
  std::vector<double> cover;
  std::vector<double> leaf_p0;
};

void tree_shap_recurse(const Tree &t, const double *xrow, double *phi_row,
                       int node, PathElement *parent_path, int unique_depth,
                       double parent_zero_fraction,
                       double parent_one_fraction, int parent_feature_index) {
  // each call works on its own copy of the path (the recursion's two
  // branches mutate it), laid out contiguously after the parent's segment
  PathElement *unique_path = parent_path + unique_depth + 1;
  std::memcpy(unique_path, parent_path,
              (unique_depth + 1) * sizeof(PathElement));
  extend_path(unique_path, unique_depth, parent_zero_fraction,
              parent_one_fraction, parent_feature_index);

  const int f = t.feature[node];
  if (f < 0) {  // leaf
    for (int i = 1; i <= unique_depth; ++i) {
      const double w = unwound_path_sum(unique_path, unique_depth, i);
      const PathElement &el = unique_path[i];
      phi_row[el.feature_index] +=
          w * (el.one_fraction - el.zero_fraction) * t.leaf_p0[node];
    }
    return;
  }

  const int hot = xrow[f] <= t.threshold[node] ? t.left[node] : t.right[node];
  const int cold = hot == t.left[node] ? t.right[node] : t.left[node];
  const double denom = t.cover[node] > 0 ? t.cover[node] : 1e-30;
  const double hot_zero_fraction = t.cover[hot] / denom;
  const double cold_zero_fraction = t.cover[cold] / denom;
  double incoming_zero_fraction = 1.0;
  double incoming_one_fraction = 1.0;

  // a feature already on the path is unwound and folded into the new element
  int path_index = 1;
  for (; path_index <= unique_depth; ++path_index)
    if (unique_path[path_index].feature_index == f) break;
  if (path_index != unique_depth + 1) {
    incoming_zero_fraction = unique_path[path_index].zero_fraction;
    incoming_one_fraction = unique_path[path_index].one_fraction;
    unwind_path(unique_path, unique_depth, path_index);
    unique_depth -= 1;
  }

  tree_shap_recurse(t, xrow, phi_row, hot, unique_path, unique_depth + 1,
                    hot_zero_fraction * incoming_zero_fraction,
                    incoming_one_fraction, f);
  tree_shap_recurse(t, xrow, phi_row, cold, unique_path, unique_depth + 1,
                    cold_zero_fraction * incoming_zero_fraction, 0.0, f);
}

int tree_max_depth(const Tree &t, int m) {
  std::vector<int> depth(m, -1);
  depth[0] = 0;
  int best = 0;
  for (int i = 0; i < m; ++i) {  // BFS ids are parent-before-child
    if (depth[i] < 0) continue;
    best = depth[i] > best ? depth[i] : best;
    const int l = t.left[i], r = t.right[i];
    if (l >= 0 && l < m) depth[l] = depth[i] + 1;
    if (r >= 0 && r < m) depth[r] = depth[i] + 1;
  }
  return best;
}

PyObject *forest_shap_class0(PyObject *, PyObject *args) {
  Py_buffer left, right, feature, threshold, value01, x, phi;
  int T, M, S, F;
  if (!PyArg_ParseTuple(args, "y*y*y*y*y*y*w*iiii", &left, &right, &feature,
                        &threshold, &value01, &x, &phi, &T, &M, &S, &F))
    return nullptr;

  struct Releaser {
    std::vector<Py_buffer *> bufs;
    ~Releaser() {
      for (auto *b : bufs) PyBuffer_Release(b);
    }
  } rel;
  rel.bufs = {&left, &right, &feature, &threshold, &value01, &x, &phi};

  if (left.len < (Py_ssize_t)sizeof(int32_t) * T * M ||
      right.len < (Py_ssize_t)sizeof(int32_t) * T * M ||
      feature.len < (Py_ssize_t)sizeof(int32_t) * T * M ||
      threshold.len < (Py_ssize_t)sizeof(double) * T * M ||
      value01.len < (Py_ssize_t)sizeof(double) * T * M * 2 ||
      x.len < (Py_ssize_t)sizeof(double) * S * F ||
      phi.len < (Py_ssize_t)sizeof(double) * S * F) {
    PyErr_SetString(PyExc_ValueError, "buffer too small for claimed shape");
    return nullptr;
  }

  const double *xp = static_cast<const double *>(x.buf);
  double *php = static_cast<double *>(phi.buf);
  std::memset(php, 0, sizeof(double) * S * F);

  Py_BEGIN_ALLOW_THREADS;
  for (int ti = 0; ti < T; ++ti) {
    Tree t;
    t.left = static_cast<const int32_t *>(left.buf) + (size_t)ti * M;
    t.right = static_cast<const int32_t *>(right.buf) + (size_t)ti * M;
    t.feature = static_cast<const int32_t *>(feature.buf) + (size_t)ti * M;
    t.threshold = static_cast<const double *>(threshold.buf) + (size_t)ti * M;
    t.value01 = static_cast<const double *>(value01.buf) + (size_t)ti * M * 2;
    t.cover.resize(M);
    t.leaf_p0.resize(M);
    for (int m = 0; m < M; ++m) {
      t.cover[m] = t.value01[2 * m] + t.value01[2 * m + 1];
      t.leaf_p0[m] = t.value01[2 * m] / (t.cover[m] > 0 ? t.cover[m] : 1e-30);
    }
    const int maxd = tree_max_depth(t, M);
    // recursion chain holds one path copy per level; level d's copy has
    // d + 2 elements (incl. the dummy), total bounded by the arena below
    std::vector<PathElement> arena(((size_t)maxd + 2) * (maxd + 3) / 2 + 2);
    for (int s = 0; s < S; ++s) {
      arena[0] = {-1, 1.0, 1.0, 1.0};
      // depth-0 call copies from arena[0..0] into arena[1..]
      tree_shap_recurse(t, xp + (size_t)s * F, php + (size_t)s * F, 0,
                        arena.data(), 0, 1.0, 1.0, -1);
    }
  }
  const double inv = 1.0 / (T > 0 ? T : 1);
  for (Py_ssize_t i = 0; i < (Py_ssize_t)S * F; ++i) php[i] *= inv;
  Py_END_ALLOW_THREADS;

  Py_RETURN_NONE;
}

PyMethodDef methods[] = {
    {"forest_shap_class0", forest_shap_class0, METH_VARARGS,
     "Mean class-0 path-dependent Tree SHAP over a forest (C baseline)."},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_treeshap_cext",
    "shap 0.40-equivalent C Tree SHAP baseline", -1, methods,
};

}  // namespace

PyMODINIT_FUNC PyInit__treeshap_cext(void) {
  return PyModule_Create(&moduledef);
}
