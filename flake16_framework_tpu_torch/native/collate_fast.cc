// The collation's hot loops in C++ (the port's copy of the JAX package's
// native/collate_fast.cc, with the same contracts as the Python bodies
// beside runner/collate.py's entry points):
//   numbits_to_lines(bytes) -> set[int]
//   coverage_features(cov: {file: set[int]}, test_files, churn) -> (n, n, n)
// with churn.get(file, {}) semantics for a file that has no churn.
//
// Host code for the CPython C API, built with g++ by native/__init__.py at
// first use; runner/collate.py calls it, and a failed build raises there.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

static PyObject *numbits_to_lines(PyObject *, PyObject *arg) {
  Py_buffer buf;
  if (PyObject_GetBuffer(arg, &buf, PyBUF_SIMPLE) < 0) return nullptr;

  PyObject *out = PySet_New(nullptr);
  if (!out) {
    PyBuffer_Release(&buf);
    return nullptr;
  }

  const unsigned char *bytes = static_cast<const unsigned char *>(buf.buf);
  for (Py_ssize_t n = 0; n < buf.len; ++n) {
    unsigned int byte = bytes[n];
    while (byte) {
      int k = __builtin_ctz(byte);
      byte &= byte - 1;
      PyObject *v = PyLong_FromSsize_t(8 * n + k);
      if (!v || PySet_Add(out, v) < 0) {
        Py_XDECREF(v);
        Py_DECREF(out);
        PyBuffer_Release(&buf);
        return nullptr;
      }
      Py_DECREF(v);
    }
  }
  PyBuffer_Release(&buf);
  return out;
}

static PyObject *coverage_features(PyObject *, PyObject *args) {
  PyObject *cov, *test_files, *churn;
  if (!PyArg_ParseTuple(args, "OOO", &cov, &test_files, &churn))
    return nullptr;

  long long n_lines = 0, n_changes = 0, n_src_lines = 0;

  PyObject *file, *lines;
  Py_ssize_t pos = 0;
  while (PyDict_Next(cov, &pos, &file, &lines)) {
    Py_ssize_t size = PyObject_Size(lines);
    if (size < 0) return nullptr;
    n_lines += size;

    int is_test = PySequence_Contains(test_files, file);
    if (is_test < 0) return nullptr;
    if (!is_test) n_src_lines += size;

    PyObject *file_churn = PyDict_GetItemWithError(churn, file);  // borrowed
    if (!file_churn) {
      if (PyErr_Occurred()) return nullptr;
      continue;  // churn.get(file, {}) semantics
    }

    PyObject *iter = PyObject_GetIter(lines);
    if (!iter) return nullptr;
    PyObject *line;
    while ((line = PyIter_Next(iter))) {
      PyObject *count = PyDict_GetItemWithError(file_churn, line);  // borrowed
      Py_DECREF(line);
      if (count) {
        long long c = PyLong_AsLongLong(count);
        if (c == -1 && PyErr_Occurred()) {
          Py_DECREF(iter);
          return nullptr;
        }
        n_changes += c;
      } else if (PyErr_Occurred()) {
        Py_DECREF(iter);
        return nullptr;
      }
    }
    Py_DECREF(iter);
    if (PyErr_Occurred()) return nullptr;
  }

  return Py_BuildValue("(LLL)", n_lines, n_changes, n_src_lines);
}

static PyMethodDef methods[] = {
    {"numbits_to_lines", numbits_to_lines, METH_O,
     "Decode a coverage numbits blob into a set of line numbers."},
    {"coverage_features", coverage_features, METH_VARARGS,
     "(covered lines, churn-weighted covered changes, source-only covered "
     "lines) for one test's coverage dict."},
    {nullptr, nullptr, 0, nullptr},
};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_collate_fast",
    "Native collation hot loops (see module header).", -1, methods,
};

PyMODINIT_FUNC PyInit__collate_fast(void) {
  return PyModule_Create(&moduledef);
}
