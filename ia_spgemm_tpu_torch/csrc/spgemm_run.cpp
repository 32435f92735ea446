// spgemm-run for the PyTorch port: a native binary that embeds
// CPython and runs the port's CLI.
//
// The reference is a C++ main that embeds the Python interpreter to call
// its ML selector (IA-SPGEMM-CPU_release/main.cpp:682-704: Py_Initialize,
// sys.path.append, import MatNet, PyEval_CallObject). Here the compute
// pipeline is the port's PyTorch and CUDA code and the main is native,
// over the same embedded-CPython C API: start the interpreter as the one
// the binary was built with (so that its site-packages, torch included,
// resolve), put the checkout's root first on sys.path, import
// ia_spgemm_tpu_torch.cli.main, call main(argv[1:]) and return its exit
// code.
//
// Built at first use by ia_spgemm_tpu_torch/cli/binary.py with the host
// C++ compiler and the interpreter's embedding flags (python3-config
// --embed), into the package's _kernels_build/; that module defines
// SPGEMM_PYTHON_EXE (sys.executable of the building interpreter) and
// SPGEMM_PACKAGE_ROOT (the directory that holds ia_spgemm_tpu_torch/).
//
// Usage:  spgemm-run A.mtx [B.mtx] [--mode all|autotune|ALG] ...
//         (python -m ia_spgemm_tpu_torch.cli.binary builds it and prints
//         its path)
#include <Python.h>

#include <cstdio>

#ifndef SPGEMM_PYTHON_EXE
#error "SPGEMM_PYTHON_EXE: the interpreter to embed (cli/binary.py sets it)"
#endif
#ifndef SPGEMM_PACKAGE_ROOT
#error "SPGEMM_PACKAGE_ROOT: the checkout's root (cli/binary.py sets it)"
#endif

int main(int argc, char** argv) {
  PyConfig config;
  PyConfig_InitPythonConfig(&config);
  config.parse_argv = 0;  // the arguments are the CLI's, not Python's

  // the interpreter's own path: its prefix (a virtual environment's
  // pyvenv.cfg included) and so its site-packages follow from it
  PyStatus st = PyConfig_SetBytesString(&config, &config.program_name,
                                        SPGEMM_PYTHON_EXE);
  if (!PyStatus_Exception(st)) {
    st = PyConfig_SetBytesArgv(&config, argc, argv);
  }
  if (!PyStatus_Exception(st)) {
    st = Py_InitializeFromConfig(&config);
  }
  PyConfig_Clear(&config);
  if (PyStatus_Exception(st)) {
    Py_ExitStatusException(st);
  }

  // the package imports from the checkout's root, whatever the working
  // directory (the reference appends './', main.cpp:684)
  PyObject* path = PySys_GetObject("path");  // borrowed
  PyObject* root = PyUnicode_DecodeFSDefault(SPGEMM_PACKAGE_ROOT);
  if (path == nullptr || root == nullptr || PyList_Insert(path, 0, root)) {
    PyErr_Print();
    Py_XDECREF(root);
    Py_Finalize();
    return 1;
  }
  Py_DECREF(root);

  PyObject* mod = PyImport_ImportModule("ia_spgemm_tpu_torch.cli.main");
  if (mod == nullptr) {
    PyErr_Print();
    std::fprintf(stderr, "spgemm-run: cannot import "
                         "ia_spgemm_tpu_torch.cli.main from %s\n",
                 SPGEMM_PACKAGE_ROOT);
    Py_Finalize();
    return 1;
  }
  PyObject* fn = PyObject_GetAttrString(mod, "main");
  Py_DECREF(mod);
  if (fn == nullptr || !PyCallable_Check(fn)) {
    PyErr_Print();
    Py_XDECREF(fn);
    Py_Finalize();
    return 1;
  }

  // main(argv[1:]): the reference passes its doubles through
  // Py_BuildValue (main.cpp:697-703); the CLI's arguments pass as a list
  PyObject* args = PyList_New(argc - 1);
  for (int i = 1; args != nullptr && i < argc; ++i) {
    PyList_SET_ITEM(args, i - 1, PyUnicode_DecodeFSDefault(argv[i]));
  }
  PyObject* result =
      args == nullptr ? nullptr
                      : PyObject_CallFunctionObjArgs(fn, args, nullptr);
  Py_XDECREF(args);
  Py_DECREF(fn);
  int rc = 1;
  if (result == nullptr) {
    // a SystemExit (argparse's --help and usage errors) ends the process
    // here with its code; any other exception prints its traceback
    PyErr_Print();
  } else {
    rc = static_cast<int>(PyLong_AsLong(result));
    if (PyErr_Occurred()) {
      PyErr_Print();
      rc = 1;
    }
    Py_DECREF(result);
  }
  if (Py_FinalizeEx() < 0) {
    rc = 120;
  }
  return rc;
}
