/* The native host packer of a fill step's flat int32 batch buffer.
 *
 * A plain CPython extension (no torch headers): engine/hostops.py builds it
 * at first use with the host C++ compiler. engine/params_builder.py calls it
 * for every batch whose requests each fill a contiguous run of positions and
 * cache slots; it writes the token ids, positions, query maps, the virtual
 * to physical KV slot translation, the block tables and cu_q_lens in one C
 * pass, where the Python packer (the oracle, and the path for the other
 * batches) takes about ten Python loops.
 *
 * Buffer layout (the core fields of models/factory.py:pack_fill_batch; the
 * M-RoPE streams and the sampling tail follow, written in Python):
 *   [token_ids(T), positions(T), q_seq_ids(T), q_local_ids(T),
 *    new_kv_slot_ids(T), token_src_slots(T),
 *    kv_lens(S), sample_token_idx(S), sample_dst_slots(S),
 *    block_tables(S*MB), cu_q_lens(S+1), num_seqs(1),
 *    image_slot_ids(Ti), image_dst_idx(Ti)]
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdint>

namespace {

struct Region {
  int32_t *token_ids, *positions, *q_seq_ids, *q_local_ids;
  int32_t *new_slots, *src_slots, *kv_lens, *sample_idx, *dst_slots;
  int32_t *tables, *cu, *num_seqs, *img_slots, *img_dst;
};

Region layout(int32_t *base, long T, long S, long MB, long Ti) {
  Region r;
  r.token_ids = base;
  r.positions = r.token_ids + T;
  r.q_seq_ids = r.positions + T;
  r.q_local_ids = r.q_seq_ids + T;
  r.new_slots = r.q_local_ids + T;
  r.src_slots = r.new_slots + T;
  r.kv_lens = r.src_slots + T;
  r.sample_idx = r.kv_lens + S;
  r.dst_slots = r.sample_idx + S;
  r.tables = r.dst_slots + S;
  r.cu = r.tables + S * MB;
  r.num_seqs = r.cu + S + 1;
  r.img_slots = r.num_seqs + 1;
  r.img_dst = r.img_slots + Ti;
  return r;
}

// Fills the buffer; returns false with a Python error set.
bool pack(const Region &r, long T, long S, long MB, long Ti, long block_size,
          PyObject *seqs, PyObject *img_slots_obj, PyObject *img_dst_obj) {
  for (long t = 0; t < T; t++) {
    r.token_ids[t] = 0;
    r.positions[t] = 0;
    r.q_seq_ids[t] = -1;
    r.q_local_ids[t] = 0;
    r.new_slots[t] = -1;
    r.src_slots[t] = -1;
  }
  for (long s = 0; s < S; s++) {
    r.kv_lens[s] = 0;
    r.sample_idx[s] = -1;
    r.dst_slots[s] = -1;
  }
  for (long i = 0; i < S * MB; i++) r.tables[i] = -1;

  long n_seqs = PySequence_Fast_GET_SIZE(seqs);
  long t = 0;
  r.cu[0] = 0;
  for (long s = 0; s < n_seqs; s++) {
    PyObject *tup =
        PySequence_Fast(PySequence_Fast_GET_ITEM(seqs, s), "a sequence's tuple");
    if (!tup) return false;
    if (PySequence_Fast_GET_SIZE(tup) != 8) {
      Py_DECREF(tup);
      PyErr_SetString(PyExc_ValueError, "a sequence's tuple has 8 fields");
      return false;
    }
    PyObject **f = PySequence_Fast_ITEMS(tup);
    long pos_start = PyLong_AsLong(f[1]);
    long n = PyLong_AsLong(f[2]);
    long token_slot = PyLong_AsLong(f[3]);
    long kv_len = PyLong_AsLong(f[4]);
    long dst_slot = PyLong_AsLong(f[5]);
    long cache_start = PyLong_AsLong(f[7]);
    if (PyErr_Occurred()) { Py_DECREF(tup); return false; }
    if (n < 0 || t + n > T || s >= S) {
      Py_DECREF(tup);
      PyErr_SetString(PyExc_ValueError, "batch overflows buckets");
      return false;
    }
    PyObject *table = PySequence_Fast(f[6], "a block table");
    if (!table) { Py_DECREF(tup); return false; }
    long n_blocks = PySequence_Fast_GET_SIZE(table);
    if (n_blocks > MB) {
      Py_DECREF(table);
      Py_DECREF(tup);
      PyErr_Format(PyExc_ValueError, "block table %ld > MB %ld", n_blocks, MB);
      return false;
    }
    for (long b = 0; b < n_blocks; b++)
      r.tables[s * MB + b] =
          (int32_t)PyLong_AsLong(PySequence_Fast_GET_ITEM(table, b));
    Py_DECREF(table);

    if (n > 0 &&
        (cache_start < 0 || (cache_start + n - 1) / block_size >= n_blocks)) {
      Py_DECREF(tup);
      PyErr_Format(PyExc_ValueError, "cache ids %ld..%ld outside %ld blocks",
                   cache_start, cache_start + n - 1, n_blocks);
      return false;
    }
    for (long i = 0; i < n; i++) {
      long cid = cache_start + i;
      r.positions[t + i] = (int32_t)(pos_start + i);
      r.q_seq_ids[t + i] = (int32_t)s;
      r.q_local_ids[t + i] = (int32_t)i;
      r.new_slots[t + i] = r.tables[s * MB + cid / block_size] * block_size +
                           (int32_t)(cid % block_size);
    }
    if (f[0] == Py_None) {
      // an unresolved decode token: the step reads it from the token table
      r.token_ids[t] = 0;
      r.src_slots[t] = (int32_t)token_slot;
    } else {
      PyObject *toks = PySequence_Fast(f[0], "token ids");
      if (!toks) { Py_DECREF(tup); return false; }
      if (PySequence_Fast_GET_SIZE(toks) < n) {
        Py_DECREF(toks);
        Py_DECREF(tup);
        PyErr_SetString(PyExc_ValueError, "fewer token ids than tokens");
        return false;
      }
      for (long i = 0; i < n; i++)
        r.token_ids[t + i] =
            (int32_t)PyLong_AsLong(PySequence_Fast_GET_ITEM(toks, i));
      Py_DECREF(toks);
    }
    Py_DECREF(tup);
    if (PyErr_Occurred()) return false;
    t += n;
    r.kv_lens[s] = (int32_t)kv_len;
    r.sample_idx[s] = (int32_t)(t - 1);
    r.dst_slots[s] = (int32_t)dst_slot;
    r.cu[s + 1] = (int32_t)t;
  }
  for (long s = n_seqs; s < S; s++) r.cu[s + 1] = (int32_t)t;
  r.num_seqs[0] = (int32_t)n_seqs;

  PyObject *slots = PySequence_Fast(img_slots_obj, "image slot ids");
  if (!slots) return false;
  PyObject *dst = PySequence_Fast(img_dst_obj, "image destination ids");
  if (!dst) { Py_DECREF(slots); return false; }
  long n_img = PySequence_Fast_GET_SIZE(slots);
  if (n_img > Ti || PySequence_Fast_GET_SIZE(dst) != n_img) {
    Py_DECREF(slots);
    Py_DECREF(dst);
    PyErr_SetString(PyExc_ValueError, "image ids overflow Ti or differ in length");
    return false;
  }
  for (long i = 0; i < Ti; i++) {
    r.img_slots[i] = i < n_img
        ? (int32_t)PyLong_AsLong(PySequence_Fast_GET_ITEM(slots, i)) : 0;
    r.img_dst[i] = i < n_img
        ? (int32_t)PyLong_AsLong(PySequence_Fast_GET_ITEM(dst, i)) : -1;
  }
  Py_DECREF(slots);
  Py_DECREF(dst);
  return !PyErr_Occurred();
}

// pack_fill_batch(out, T, S, MB, Ti, block_size, seqs, img_slots, img_dst)
// seqs: a list of tuples (token_ids: None | list[int], pos_start, n_tokens,
//                         token_slot, kv_len, dst_slot, block_table: list[int],
//                         cache_start)
PyObject *pack_fill_batch(PyObject *, PyObject *args) {
  Py_buffer out;
  long T, S, MB, Ti, block_size;
  PyObject *seqs_obj, *img_slots_obj, *img_dst_obj;
  if (!PyArg_ParseTuple(args, "w*lllllOOO", &out, &T, &S, &MB, &Ti,
                        &block_size, &seqs_obj, &img_slots_obj, &img_dst_obj))
    return nullptr;
  if (T < 0 || S < 0 || MB < 0 || Ti < 0 || block_size <= 0) {
    PyBuffer_Release(&out);
    PyErr_SetString(PyExc_ValueError, "negative dims or block_size <= 0");
    return nullptr;
  }
  long need = 6 * T + 3 * S + S * MB + (S + 1) + 1 + 2 * Ti;
  if ((long)(out.len / sizeof(int32_t)) != need) {
    PyBuffer_Release(&out);
    return PyErr_Format(PyExc_ValueError, "buffer has %ld i32, need %ld",
                        (long)(out.len / sizeof(int32_t)), need);
  }
  if (!PyBuffer_IsContiguous(&out, 'C')) {
    PyBuffer_Release(&out);
    PyErr_SetString(PyExc_ValueError, "the buffer must be contiguous");
    return nullptr;
  }
  PyObject *seqs = PySequence_Fast(seqs_obj, "seqs");
  bool ok = seqs != nullptr &&
            pack(layout((int32_t *)out.buf, T, S, MB, Ti), T, S, MB, Ti,
                 block_size, seqs, img_slots_obj, img_dst_obj);
  Py_XDECREF(seqs);
  PyBuffer_Release(&out);
  if (!ok) return nullptr;
  Py_RETURN_NONE;
}

PyMethodDef methods[] = {
    {"pack_fill_batch", pack_fill_batch, METH_VARARGS,
     "Pack one fill step's flat int32 batch buffer (its core fields)."},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef moduledef = {PyModuleDef_HEAD_INIT, "hostops",
                         "native host-side batch packing", -1, methods};

}  // namespace

PyMODINIT_FUNC PyInit_hostops(void) { return PyModule_Create(&moduledef); }
