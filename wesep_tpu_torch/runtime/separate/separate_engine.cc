#include "separate/separate_engine.h"

#include <Python.h>

#include <cstdlib>
#include <cstring>
#include <stdexcept>

#include "frontend/feature_pipeline.h"

// Set by wesep_tpu_torch/runtime/build.py: the interpreter that built the
// binary (its prefix, a venv's included, is found from it) and the root of
// the checkout that holds wesep_tpu_torch.
#ifndef WESEP_PYTHON_EXECUTABLE
#define WESEP_PYTHON_EXECUTABLE ""
#endif
#ifndef WESEP_REPO_ROOT
#define WESEP_REPO_ROOT ""
#endif

namespace wesep {

namespace {

void Check(PyObject* obj, const char* what) {
  if (obj == nullptr) {
    PyErr_Print();
    throw std::runtime_error(std::string("python error in ") + what);
  }
}

void CheckStatus(PyStatus status, const char* what) {
  if (PyStatus_Exception(status)) {
    throw std::runtime_error(std::string(what) + ": " +
                             (status.err_msg ? status.err_msg : "failed"));
  }
}

// Put `entry` at `index` of sys.path unless it is there already.
void InsertPath(PyObject* sys_path, Py_ssize_t index,
                const std::string& entry) {
  if (entry.empty()) return;
  PyObject* item = PyUnicode_DecodeFSDefault(entry.c_str());
  Check(item, "sys.path entry");
  int found = PySequence_Contains(sys_path, item);
  int failed = found < 0 || (found == 0 &&
                             PyList_Insert(sys_path, index, item) != 0);
  Py_DECREF(item);
  if (failed) Check(nullptr, "sys.path insert");
}

// Start the interpreter as the one that built the binary would start, so
// its site-packages (torch, numpy, yaml) are on sys.path; then put
// WESEP_PYTHONPATH's entries (':'-separated, in order) and the checkout's
// root before the rest.
void StartPython() {
  if (Py_IsInitialized()) {
    throw std::runtime_error("the engine starts the interpreter; one engine "
                             "a process");
  }
  PyConfig config;
  PyConfig_InitPythonConfig(&config);
  config.install_signal_handlers = 0;
  if (std::strlen(WESEP_PYTHON_EXECUTABLE) > 0) {
    PyStatus status = PyConfig_SetBytesString(&config, &config.program_name,
                                              WESEP_PYTHON_EXECUTABLE);
    if (PyStatus_Exception(status)) PyConfig_Clear(&config);
    CheckStatus(status, "PyConfig program_name");
  }
  PyStatus status = Py_InitializeFromConfig(&config);
  PyConfig_Clear(&config);
  CheckStatus(status, "Py_InitializeFromConfig");

  PyObject* sys_path = PySys_GetObject("path");  // borrowed
  Check(sys_path, "sys.path");
  Py_ssize_t at = 0;
  const char* extra = std::getenv("WESEP_PYTHONPATH");
  std::string entries = extra != nullptr ? extra : "";
  size_t start = 0;
  while (start <= entries.size()) {
    size_t end = entries.find(':', start);
    if (end == std::string::npos) end = entries.size();
    std::string entry = entries.substr(start, end - start);
    if (!entry.empty()) InsertPath(sys_path, at++, entry);
    start = end + 1;
  }
  InsertPath(sys_path, at, WESEP_REPO_ROOT);
}

// Holds the GIL for the life of the object.
class Gil {
 public:
  Gil() : state_(PyGILState_Ensure()) {}
  ~Gil() { PyGILState_Release(state_); }
  Gil(const Gil&) = delete;
  Gil& operator=(const Gil&) = delete;

 private:
  PyGILState_STATE state_;
};

// Zero-copy view of a C float buffer as a 1-D numpy array: memoryview ->
// np.frombuffer shares the memory, no per-sample boxing. The caller's
// buffer must outlive every python use of the array; runtime_host stacks
// the request into new arrays before it calls the model, so the lifetime
// ends with the separate() call.
PyObject* ArrayFromBuffer(PyObject* np, const float* data, size_t n) {
  PyObject* mv = PyMemoryView_FromMemory(
      reinterpret_cast<char*>(const_cast<float*>(data)),
      static_cast<Py_ssize_t>(n * sizeof(float)), PyBUF_READ);
  Check(mv, "memoryview");
  PyObject* arr = PyObject_CallMethod(np, "frombuffer", "Os", mv, "float32");
  Py_DECREF(mv);
  Check(arr, "np.frombuffer");
  return arr;
}

}  // namespace

SeparateEngine::SeparateEngine(const std::string& model_path,
                               const std::string& device, int feat_dim,
                               int sample_rate)
    : feat_dim_(feat_dim), sample_rate_(sample_rate) {
  StartPython();
  try {
    PyObject* np = PyImport_ImportModule("numpy");
    Check(np, "import numpy");
    numpy_ = np;
    PyObject* mod = PyImport_ImportModule("wesep_tpu_torch.runtime_host");
    Check(mod, "import wesep_tpu_torch.runtime_host");
    host_module_ = mod;
    PyObject* ret = PyObject_CallMethod(mod, "load", "ss", model_path.c_str(),
                                        device.c_str());
    Check(ret, "runtime_host.load");
    sample_rate_ = static_cast<int>(PyLong_AsLong(ret));
    Py_DECREF(ret);
    if (PyErr_Occurred()) Check(nullptr, "runtime_host.load's sample rate");
    PyObject* fb = PyObject_CallMethod(mod, "expects_fbank", nullptr);
    Check(fb, "runtime_host.expects_fbank");
    const int truth = PyObject_IsTrue(fb);
    Py_DECREF(fb);
    if (truth < 0) Check(nullptr, "runtime_host.expects_fbank's value");
    expects_fbank_ = truth == 1;
  } catch (...) {
    Py_XDECREF(reinterpret_cast<PyObject*>(host_module_));
    Py_XDECREF(reinterpret_cast<PyObject*>(numpy_));
    Py_FinalizeEx();
    throw;
  }
  // the GIL is taken again for each call (Gil)
  main_thread_ = PyEval_SaveThread();
}

SeparateEngine::~SeparateEngine() {
  PyEval_RestoreThread(reinterpret_cast<PyThreadState*>(main_thread_));
  // the host drops its model and tensors and waits for the card before the
  // interpreter (and with it torch's CUDA state) goes down
  PyObject* mod = reinterpret_cast<PyObject*>(host_module_);
  PyObject* ret = PyObject_CallMethod(mod, "unload", nullptr);
  if (ret == nullptr) PyErr_Print();
  Py_XDECREF(ret);
  Py_XDECREF(mod);
  Py_XDECREF(reinterpret_cast<PyObject*>(numpy_));
  Py_FinalizeEx();
}

std::string SeparateEngine::KernelLaunches() {
  Gil gil;
  PyObject* counts = PyObject_CallMethod(
      reinterpret_cast<PyObject*>(host_module_), "launches", nullptr);
  Check(counts, "runtime_host.launches");
  PyObject* json = PyImport_ImportModule("json");
  PyObject* text = json == nullptr
                       ? nullptr
                       : PyObject_CallMethod(json, "dumps", "O", counts);
  Py_DECREF(counts);
  Py_XDECREF(json);
  Check(text, "json.dumps of the launches");
  const char* utf8 = PyUnicode_AsUTF8(text);
  std::string out = utf8 != nullptr ? utf8 : "";
  Py_DECREF(text);
  if (utf8 == nullptr) Check(nullptr, "the launches' text");
  return out;
}

std::vector<float> SeparateEngine::ExtractFeature(
    const std::vector<float>& wav, int* num_frames) const {
  return FbankWithMeanNorm(wav, feat_dim_, sample_rate_, num_frames);
}

void SeparateEngine::ForwardFunc(const std::vector<float>& mix,
                                 const std::vector<float>& enroll1,
                                 const std::vector<float>& enroll2,
                                 std::vector<std::vector<float>>* outputs) {
  // the features are computed before the GIL is taken
  int n1 = 0, n2 = 0;
  std::vector<float> f1, f2;
  if (expects_fbank_) {
    f1 = ExtractFeature(enroll1, &n1);
    f2 = ExtractFeature(enroll2, &n2);
  }
  Gil gil;
  PyObject* np = reinterpret_cast<PyObject*>(numpy_);
  PyObject* mod = reinterpret_cast<PyObject*>(host_module_);

  auto make_array = [&](const std::vector<float>& data, int rows,
                        int cols) -> PyObject* {
    PyObject* arr = ArrayFromBuffer(np, data.data(), data.size());
    if (rows > 0) {
      PyObject* shaped =
          PyObject_CallMethod(arr, "reshape", "(ii)", rows, cols);
      Py_DECREF(arr);
      Check(shaped, "reshape");
      return shaped;
    }
    return arr;
  };

  PyObject* mix_arr = make_array(mix, 0, 0);
  PyObject* e1_arr = expects_fbank_ ? make_array(f1, n1, feat_dim_)
                                    : make_array(enroll1, 0, 0);
  PyObject* e2_arr = expects_fbank_ ? make_array(f2, n2, feat_dim_)
                                    : make_array(enroll2, 0, 0);
  PyObject* ret = PyObject_CallMethod(mod, "separate", "OOO", mix_arr,
                                      e1_arr, e2_arr);
  Py_DECREF(mix_arr);
  Py_DECREF(e1_arr);
  Py_DECREF(e2_arr);
  Check(ret, "runtime_host.separate");

  // ret: np.ndarray [N, T] float32 -> one bulk memcpy per row via the
  // buffer protocol (the reverse of ArrayFromBuffer; no boxed floats)
  outputs->clear();
  PyObject* contig =
      PyObject_CallMethod(np, "ascontiguousarray", "Os", ret, "float32");
  Py_DECREF(ret);
  Check(contig, "ascontiguousarray");
  Py_buffer view;
  if (PyObject_GetBuffer(contig, &view, PyBUF_C_CONTIGUOUS | PyBUF_FORMAT) !=
      0) {
    PyErr_Print();
    Py_DECREF(contig);
    throw std::runtime_error("separate output does not expose a buffer");
  }
  if (view.ndim != 2) {
    PyBuffer_Release(&view);
    Py_DECREF(contig);
    throw std::runtime_error("separate output is not 2-D");
  }
  const Py_ssize_t n_out = view.shape[0];
  const Py_ssize_t t = view.shape[1];
  const float* src = static_cast<const float*>(view.buf);
  for (Py_ssize_t i = 0; i < n_out; ++i) {
    outputs->emplace_back(src + i * t, src + (i + 1) * t);
  }
  PyBuffer_Release(&view);
  Py_DECREF(contig);
}

}  // namespace wesep
