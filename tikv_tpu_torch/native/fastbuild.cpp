/* Native MVCC -> columnar builder: the data-loader hot loop.
 *
 * The port's own copy of the JAX package's native module (reference
 * roles: RocksDB's C++ iterators + tidb_query_datatype's row decode, the
 * scan->batch handoff of src/coprocessor/dag/storage_impl.rs).  Four
 * entries, each byte-for-byte the same output as the JAX package's:
 *
 *  - mvcc_build_columnar: one pass over a CF_WRITE range resolving
 *    Percolator versions at read_ts and decoding row payloads straight
 *    into int64/float64/uint64 buffers (the build ladder's native rung);
 *  - mvcc_parse_planes: the flat-plane parse of a CF_WRITE range for the
 *    device's version resolution (schema or discovery mode; the core loop
 *    may release the GIL);
 *  - checksum_pairs: the crc64-xz XOR fold of the CHECKSUM request;
 *  - build_mvcc_sst: the bulk-load v2 SST container from column buffers.
 *
 * Formats parsed here (kept in lockstep with tikv_tpu_torch's codecs):
 *  - engine key: [prefix_skip bytes] 'x' + memcomparable(user_key)
 *                + 8-byte big-endian ~commit_ts   (storage/txn_types.py)
 *  - user key:   't' + be64(table_id^sign) + "_r" + be64(handle^sign)
 *                (codec/keys.py)
 *  - write record: type byte 'P'/'D'/'L'/'R' + varint(start_ts)
 *                [+ 'v' varint(len) short_value] [+ 'R']  (txn_types.py)
 *  - row payload: msgpack map {int column_id: nil|int|float|bin|str}
 *                (codec/row.py)
 *
 * Anything outside this envelope (unknown msgpack tag, malformed key)
 * raises ValueError; the Python caller takes the next rung of its ladder.
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace {

constexpr uint64_t kSignMask = 0x8000000000000000ULL;

inline uint64_t be64(const uint8_t* p) {
  uint64_t v = 0;
  for (int i = 0; i < 8; i++) v = (v << 8) | p[i];
  return v;
}

int read_varu64(const uint8_t* p, Py_ssize_t len, Py_ssize_t* off,
                uint64_t* out) {
  int shift = 0;
  uint64_t v = 0;
  while (*off < len) {
    uint8_t b = p[(*off)++];
    v |= (uint64_t)(b & 0x7F) << shift;
    if (!(b & 0x80)) {
      *out = v;
      return 0;
    }
    shift += 7;
    if (shift > 63) return -1;
  }
  return -1;
}

/* memcomparable decode (codec/number.py decode_bytes_memcomparable) */
int mc_decode(const uint8_t* p, Py_ssize_t len, Py_ssize_t* off,
              std::string* out) {
  out->clear();
  for (;;) {
    if (*off + 9 > len) return -1;
    uint8_t marker = p[*off + 8];
    int pad = 0xFF - (int)marker;
    if (pad < 0 || pad > 8) return -1;
    out->append(reinterpret_cast<const char*>(p) + *off, 8 - pad);
    *off += 9;
    if (pad != 0) return 0;
  }
}

/* minimal msgpack value (codec/row.py envelope) */
struct MpVal {
  enum { NIL, INT, FLT, BIN } type;
  int64_t i;
  double f;
  const uint8_t* b;
  uint32_t blen;
};

int mp_read(const uint8_t* p, Py_ssize_t len, Py_ssize_t* off, MpVal* v) {
  if (*off >= len) return -1;
  uint8_t t = p[(*off)++];
  if (t <= 0x7F) { v->type = MpVal::INT; v->i = t; return 0; }
  if (t >= 0xE0) { v->type = MpVal::INT; v->i = (int8_t)t; return 0; }
  auto need = [&](Py_ssize_t n) { return *off + n <= len; };
  switch (t) {
    case 0xC0: v->type = MpVal::NIL; return 0;
    case 0xC2: v->type = MpVal::INT; v->i = 0; return 0;
    case 0xC3: v->type = MpVal::INT; v->i = 1; return 0;
    case 0xCC: if (!need(1)) return -1;
      v->type = MpVal::INT; v->i = p[(*off)++]; return 0;
    case 0xCD: if (!need(2)) return -1;
      v->type = MpVal::INT; v->i = (p[*off] << 8) | p[*off + 1];
      *off += 2; return 0;
    case 0xCE: if (!need(4)) return -1;
      v->type = MpVal::INT;
      v->i = ((uint32_t)p[*off] << 24) | ((uint32_t)p[*off + 1] << 16) |
             ((uint32_t)p[*off + 2] << 8) | p[*off + 3];
      *off += 4; return 0;
    case 0xCF: if (!need(8)) return -1;
      v->type = MpVal::INT; v->i = (int64_t)be64(p + *off);
      *off += 8; return 0;
    case 0xD0: if (!need(1)) return -1;
      v->type = MpVal::INT; v->i = (int8_t)p[(*off)++]; return 0;
    case 0xD1: if (!need(2)) return -1;
      v->type = MpVal::INT;
      v->i = (int16_t)((p[*off] << 8) | p[*off + 1]); *off += 2; return 0;
    case 0xD2: if (!need(4)) return -1;
      v->type = MpVal::INT;
      v->i = (int32_t)(((uint32_t)p[*off] << 24) |
                       ((uint32_t)p[*off + 1] << 16) |
                       ((uint32_t)p[*off + 2] << 8) | p[*off + 3]);
      *off += 4; return 0;
    case 0xD3: if (!need(8)) return -1;
      v->type = MpVal::INT; v->i = (int64_t)be64(p + *off);
      *off += 8; return 0;
    case 0xCA: { if (!need(4)) return -1;
      uint32_t u = ((uint32_t)p[*off] << 24) |
                   ((uint32_t)p[*off + 1] << 16) |
                   ((uint32_t)p[*off + 2] << 8) | p[*off + 3];
      float f;
      std::memcpy(&f, &u, 4);
      v->type = MpVal::FLT; v->f = f; *off += 4; return 0; }
    case 0xCB: { if (!need(8)) return -1;
      uint64_t u = be64(p + *off);
      std::memcpy(&v->f, &u, 8);
      v->type = MpVal::FLT; *off += 8; return 0; }
    case 0xC4: case 0xD9: { if (!need(1)) return -1;
      uint32_t n = p[(*off)++];
      if (!need(n)) return -1;
      v->type = MpVal::BIN; v->b = p + *off; v->blen = n;
      *off += n; return 0; }
    case 0xC5: case 0xDA: { if (!need(2)) return -1;
      uint32_t n = (p[*off] << 8) | p[*off + 1];
      *off += 2;
      if (!need(n)) return -1;
      v->type = MpVal::BIN; v->b = p + *off; v->blen = n;
      *off += n; return 0; }
    case 0xC6: case 0xDB: { if (!need(4)) return -1;
      uint32_t n = ((uint32_t)p[*off] << 24) | ((uint32_t)p[*off + 1] << 16) |
                   ((uint32_t)p[*off + 2] << 8) | p[*off + 3];
      *off += 4;
      if (!need(n)) return -1;
      v->type = MpVal::BIN; v->b = p + *off; v->blen = n;
      *off += n; return 0; }
    default:
      if (t >= 0xA0 && t <= 0xBF) {  /* fixstr */
        uint32_t n = t & 0x1F;
        if (!need(n)) return -1;
        v->type = MpVal::BIN; v->b = p + *off; v->blen = n;
        *off += n; return 0;
      }
      return -1;
  }
}

int mp_map_len(const uint8_t* p, Py_ssize_t len, Py_ssize_t* off,
               uint32_t* n) {
  if (*off >= len) return -1;
  uint8_t t = p[(*off)++];
  if ((t & 0xF0) == 0x80) { *n = t & 0x0F; return 0; }
  if (t == 0xDE) {
    if (*off + 2 > len) return -1;
    *n = (p[*off] << 8) | p[*off + 1];
    *off += 2;
    return 0;
  }
  if (t == 0xDF) {
    if (*off + 4 > len) return -1;
    *n = ((uint32_t)p[*off] << 24) | ((uint32_t)p[*off + 1] << 16) |
         ((uint32_t)p[*off + 2] << 8) | p[*off + 3];
    *off += 4;
    return 0;
  }
  return -1;
}

struct Col {
  int64_t id;
  int kind;  /* 0=int64 1=float64 2=bytes(object) 3=uint64 */
  std::vector<int64_t> i64;
  std::vector<double> f64;
  std::vector<uint64_t> u64;
  PyObject* objs;  /* list, for kind 2 */
  std::vector<uint8_t> valid;
};

PyObject* fail(const char* msg) {
  PyErr_SetString(PyExc_ValueError, msg);
  return nullptr;
}

PyObject* mvcc_build(PyObject*, PyObject* args) {
  PyObject *keys_o, *vals_o, *colids_o, *colkinds_o;
  unsigned long long read_ts;
  Py_ssize_t prefix_skip;
  if (!PyArg_ParseTuple(args, "OOKnOO", &keys_o, &vals_o, &read_ts,
                        &prefix_skip, &colids_o, &colkinds_o))
    return nullptr;

  PyObject* keys = PySequence_Fast(keys_o, "keys not a sequence");
  if (!keys) return nullptr;
  PyObject* vals = PySequence_Fast(vals_o, "values not a sequence");
  if (!vals) { Py_DECREF(keys); return nullptr; }
  Py_ssize_t n_in = PySequence_Fast_GET_SIZE(keys);
  if (PySequence_Fast_GET_SIZE(vals) != n_in) {
    Py_DECREF(keys); Py_DECREF(vals);
    return fail("keys/values length mismatch");
  }

  std::vector<Col> cols;
  Py_ssize_t ncols = PySequence_Size(colids_o);
  for (Py_ssize_t c = 0; c < ncols; c++) {
    PyObject* ido = PySequence_GetItem(colids_o, c);
    PyObject* ko = PySequence_GetItem(colkinds_o, c);
    Col col;
    col.id = PyLong_AsLongLong(ido);
    col.kind = (int)PyLong_AsLong(ko);
    col.objs = (col.kind == 2) ? PyList_New(0) : nullptr;
    Py_XDECREF(ido);
    Py_XDECREF(ko);
    cols.push_back(std::move(col));
  }

  std::vector<int64_t> handles;
  uint64_t safe_ts = 0;
  std::string user_key, prev_key;
  bool resolved = false;
  PyObject* need_default = PyList_New(0);

  auto cleanup = [&]() {
    for (auto& c : cols) Py_XDECREF(c.objs);
    Py_XDECREF(need_default);
    Py_DECREF(keys);
    Py_DECREF(vals);
  };

  for (Py_ssize_t i = 0; i < n_in; i++) {
    PyObject* ko = PySequence_Fast_GET_ITEM(keys, i);
    PyObject* vo = PySequence_Fast_GET_ITEM(vals, i);
    char* kp;
    Py_ssize_t klen;
    if (PyBytes_AsStringAndSize(ko, &kp, &klen) < 0) {
      cleanup();
      return nullptr;
    }
    const uint8_t* k = reinterpret_cast<const uint8_t*>(kp);
    Py_ssize_t off = prefix_skip;
    if (off >= klen || k[off] != 'x') { cleanup(); return fail("bad key mode"); }
    off += 1;
    if (mc_decode(k, klen - 8, &off, &user_key) < 0 || off != klen - 8) {
      cleanup();
      return fail("bad memcomparable key");
    }
    uint64_t commit_ts = ~be64(k + klen - 8);
    if (commit_ts > safe_ts) safe_ts = commit_ts;
    bool same = (user_key == prev_key);
    if (!same) {
      prev_key = user_key;
      resolved = false;
    }
    if (resolved || commit_ts > read_ts) continue;

    char* vp;
    Py_ssize_t vlen;
    if (PyBytes_AsStringAndSize(vo, &vp, &vlen) < 0) {
      cleanup();
      return nullptr;
    }
    const uint8_t* v = reinterpret_cast<const uint8_t*>(vp);
    if (vlen < 2) { cleanup(); return fail("short write record"); }
    char wt = (char)v[0];
    Py_ssize_t voff = 1;
    uint64_t start_ts;
    if (read_varu64(v, vlen, &voff, &start_ts) < 0) {
      cleanup();
      return fail("bad write start_ts");
    }
    const uint8_t* sval = nullptr;
    uint64_t svlen = 0;
    while (voff < vlen) {
      char tag = (char)v[voff++];
      if (tag == 'v') {
        if (read_varu64(v, vlen, &voff, &svlen) < 0 ||
            voff + (Py_ssize_t)svlen > vlen) {
          cleanup();
          return fail("bad short value");
        }
        sval = v + voff;
        voff += svlen;
      } else if (tag == 'R') {
        /* overlapped rollback marker on a committed write */
      } else {
        cleanup();
        return fail("bad write tag");
      }
    }
    if (wt == 'L' || wt == 'R') continue;   /* next version */
    resolved = true;
    if (wt == 'D') continue;                /* deleted at read_ts */
    if (wt != 'P') { cleanup(); return fail("bad write type"); }

    /* visible PUT: decode handle (user key 't'+8+'_r'+8) */
    if (user_key.size() < 19) { cleanup(); return fail("short record key"); }
    const uint8_t* uk = reinterpret_cast<const uint8_t*>(user_key.data());
    int64_t handle = (int64_t)(be64(uk + 11) - kSignMask);
    Py_ssize_t row = (Py_ssize_t)handles.size();
    handles.push_back(handle);
    for (auto& c : cols) {
      c.valid.push_back(0);
      switch (c.kind) {
        case 0: c.i64.push_back(0); break;
        case 1: c.f64.push_back(0.0); break;
        case 3: c.u64.push_back(0); break;
        case 2:
          if (PyList_Append(c.objs, Py_None) < 0) { cleanup(); return nullptr; }
          break;
      }
    }
    if (sval == nullptr) {
      /* big value lives in CF_DEFAULT at (key, start_ts): patched by
       * the Python caller (rare: values > SHORT_VALUE_MAX_LEN) */
      PyObject* t = Py_BuildValue(
          "nKy#", row, (unsigned long long)start_ts, user_key.data(),
          (Py_ssize_t)user_key.size());
      if (!t || PyList_Append(need_default, t) < 0) {
        Py_XDECREF(t);
        cleanup();
        return nullptr;
      }
      Py_DECREF(t);
      continue;
    }
    /* decode msgpack row map into the column slots */
    Py_ssize_t moff = 0;
    uint32_t pairs;
    if (mp_map_len(sval, (Py_ssize_t)svlen, &moff, &pairs) < 0) {
      cleanup();
      return fail("bad row map");
    }
    for (uint32_t e = 0; e < pairs; e++) {
      MpVal cid, val;
      if (mp_read(sval, (Py_ssize_t)svlen, &moff, &cid) < 0 ||
          cid.type != MpVal::INT ||
          mp_read(sval, (Py_ssize_t)svlen, &moff, &val) < 0) {
        cleanup();
        return fail("bad row datum");
      }
      for (auto& c : cols) {
        if (c.id != cid.i) continue;
        if (val.type == MpVal::NIL) break;
        c.valid[row] = 1;
        switch (c.kind) {
          case 0:
            if (val.type == MpVal::INT) c.i64[row] = val.i;
            else if (val.type == MpVal::FLT) c.i64[row] = (int64_t)val.f;
            else { cleanup(); return fail("type mismatch int col"); }
            break;
          case 1:
            if (val.type == MpVal::FLT) c.f64[row] = val.f;
            else if (val.type == MpVal::INT) c.f64[row] = (double)val.i;
            else { cleanup(); return fail("type mismatch real col"); }
            break;
          case 3:
            if (val.type == MpVal::INT) c.u64[row] = (uint64_t)val.i;
            else { cleanup(); return fail("type mismatch u64 col"); }
            break;
          case 2: {
            if (val.type != MpVal::BIN) {
              cleanup();
              return fail("type mismatch bytes col");
            }
            PyObject* b = PyBytes_FromStringAndSize(
                reinterpret_cast<const char*>(val.b), val.blen);
            if (!b) { cleanup(); return nullptr; }
            /* PyList_SetItem steals b's ref even on failure */
            if (PyList_SetItem(c.objs, row, b) < 0) {
              cleanup();
              return nullptr;
            }
            break;
          }
        }
        break;
      }
    }
  }

  Py_ssize_t n = (Py_ssize_t)handles.size();
  PyObject* handles_b = PyByteArray_FromStringAndSize(
      reinterpret_cast<const char*>(handles.data()), n * 8);
  PyObject* out_cols = PyList_New(0);
  if (!handles_b || !out_cols) {
    Py_XDECREF(handles_b);
    Py_XDECREF(out_cols);
    cleanup();
    return nullptr;
  }
  for (auto& c : cols) {
    PyObject* payload;
    if (c.kind == 2) {
      payload = c.objs;
      Py_INCREF(payload);
    } else if (c.kind == 1) {
      payload = PyByteArray_FromStringAndSize(
          reinterpret_cast<const char*>(c.f64.data()), n * 8);
    } else if (c.kind == 3) {
      payload = PyByteArray_FromStringAndSize(
          reinterpret_cast<const char*>(c.u64.data()), n * 8);
    } else {
      payload = PyByteArray_FromStringAndSize(
          reinterpret_cast<const char*>(c.i64.data()), n * 8);
    }
    PyObject* validity = PyByteArray_FromStringAndSize(
        reinterpret_cast<const char*>(c.valid.data()), n);
    PyObject* tup = (payload && validity)
        ? Py_BuildValue("(LiOO)", (long long)c.id, c.kind, payload, validity)
        : nullptr;
    Py_XDECREF(payload);
    Py_XDECREF(validity);
    if (!tup || PyList_Append(out_cols, tup) < 0) {
      Py_XDECREF(tup);
      Py_DECREF(handles_b);
      Py_DECREF(out_cols);
      cleanup();
      return nullptr;
    }
    Py_DECREF(tup);
  }
  PyObject* ret = Py_BuildValue("{s:O,s:n,s:K,s:O,s:O}",
                                "handles", handles_b, "n", n,
                                "safe_ts", (unsigned long long)safe_ts,
                                "cols", out_cols,
                                "need_default", need_default);
  Py_DECREF(handles_b);
  Py_DECREF(out_cols);
  cleanup();  /* drops our refs; ret holds its own */
  return ret;
}

/* ------------------------------------------------------------------ *
 * Flat-plane MVCC parse — the device-resolve feed (device/mvcc.py).
 *
 * Where mvcc_build resolves versions AND decodes rows in one host pass,
 * this export only PARSES: every CF_WRITE version becomes one row of a
 * set of flat, fixed-width planes (key-ordinal segments, commit_ts,
 * start_ts, write type, per-column datum planes) that upload H2D as-is,
 * so newest-committed-version selection — a segmented arg-max over
 * commit_ts — runs on the accelerator instead of in this loop.  The
 * core loop holds NO Python objects (key/value pointers are snapshotted
 * first), so it runs with the GIL RELEASED and a concurrent SST encode
 * or ingest RPC makes real progress — the property the streaming cold
 * pipeline (copr/stream_build.py) is built on.
 *
 * Envelope: numeric columns only (kinds 0=int64, 1=float64, 3=uint64 —
 * bytes columns cannot live in device planes); PUTs without a short
 * value are reported in need_default for the caller's CF_DEFAULT patch.
 *
 * Two schema modes:
 *  - explicit (col_ids non-empty): planes for exactly those columns,
 *    datums coerced to the requested kinds (the cold-build path, which
 *    knows the scan schema);
 *  - DISCOVERY (col_ids empty): the streaming ingest path has no
 *    schema yet — every column id seen in any row payload mints a
 *    plane, kind inferred from its first non-NIL datum (INT->0,
 *    FLT->1; BIN is out of envelope).  The consumer reconciles the
 *    discovered planes against the query schema at build time
 *    (device/mvcc.py align_planes).
 */

struct ParseErr {
  const char* msg = nullptr;
};

struct NeedDefault {
  int64_t row;
  uint64_t start_ts;
  std::string ukey;
};

PyObject* mvcc_parse_planes(PyObject*, PyObject* args) {
  PyObject *keys_o, *vals_o, *colids_o, *colkinds_o;
  Py_ssize_t prefix_skip;
  int release_gil = 1;
  if (!PyArg_ParseTuple(args, "OOnOO|p", &keys_o, &vals_o, &prefix_skip,
                        &colids_o, &colkinds_o, &release_gil))
    return nullptr;
  PyObject* keys = PySequence_Fast(keys_o, "keys not a sequence");
  if (!keys) return nullptr;
  PyObject* vals = PySequence_Fast(vals_o, "values not a sequence");
  if (!vals) { Py_DECREF(keys); return nullptr; }
  Py_ssize_t n_in = PySequence_Fast_GET_SIZE(keys);
  if (PySequence_Fast_GET_SIZE(vals) != n_in) {
    Py_DECREF(keys); Py_DECREF(vals);
    return fail("keys/values length mismatch");
  }

  Py_ssize_t ncols = PySequence_Size(colids_o);
  bool discover = (ncols == 0);   /* streaming mode: no schema yet */
  std::vector<int64_t> col_ids(ncols);
  std::vector<int> col_kinds(ncols);
  for (Py_ssize_t c = 0; c < ncols; c++) {
    PyObject* ido = PySequence_GetItem(colids_o, c);
    PyObject* ko = PySequence_GetItem(colkinds_o, c);
    col_ids[c] = PyLong_AsLongLong(ido);
    col_kinds[c] = (int)PyLong_AsLong(ko);
    Py_XDECREF(ido); Py_XDECREF(ko);
    if (col_kinds[c] != 0 && col_kinds[c] != 1 && col_kinds[c] != 3) {
      Py_DECREF(keys); Py_DECREF(vals);
      return fail("plane parse supports numeric kinds only");
    }
  }

  /* pass 1 (GIL held): snapshot raw (ptr, len) for every key/value */
  std::vector<const uint8_t*> kp(n_in), vp(n_in);
  std::vector<Py_ssize_t> kl(n_in), vl(n_in);
  for (Py_ssize_t i = 0; i < n_in; i++) {
    char* p;
    Py_ssize_t l;
    if (PyBytes_AsStringAndSize(PySequence_Fast_GET_ITEM(keys, i), &p,
                                &l) < 0) {
      Py_DECREF(keys); Py_DECREF(vals);
      return nullptr;
    }
    kp[i] = reinterpret_cast<const uint8_t*>(p);
    kl[i] = l;
    if (PyBytes_AsStringAndSize(PySequence_Fast_GET_ITEM(vals, i), &p,
                                &l) < 0) {
      Py_DECREF(keys); Py_DECREF(vals);
      return nullptr;
    }
    vp[i] = reinterpret_cast<const uint8_t*>(p);
    vl[i] = l;
  }

  /* pass 2 (GIL released): parse into preallocated flat planes */
  std::vector<uint64_t> commit_ts(n_in), start_ts(n_in);
  std::vector<uint8_t> wtype(n_in), has_payload(n_in, 0);
  std::vector<int32_t> seg_id(n_in);
  std::vector<int64_t> handles;        /* per key */
  std::vector<int64_t> seg_start;      /* n_keys + 1 offsets */
  handles.reserve(n_in);
  seg_start.reserve(n_in + 1);
  struct PlaneCol {
    int kind;
    std::vector<int64_t> i64;
    std::vector<double> f64;
    std::vector<uint64_t> u64;
    std::vector<uint8_t> valid;
  };
  std::vector<PlaneCol> planes(ncols);
  for (Py_ssize_t c = 0; c < ncols; c++) {
    planes[c].kind = col_kinds[c];
    planes[c].valid.assign(n_in, 0);
    if (col_kinds[c] == 1) planes[c].f64.assign(n_in, 0.0);
    else if (col_kinds[c] == 3) planes[c].u64.assign(n_in, 0);
    else planes[c].i64.assign(n_in, 0);
  }
  std::vector<NeedDefault> need;
  uint64_t safe_ts = 0;
  int64_t table_id = 0;
  ParseErr err;

  /* release_gil=0: the cold-build path on a single-CPU box — there,
   * yielding the GIL only hands the core to the node's background
   * tick threads and the parse's wall time balloons (measured 3.8s →
   * 18s at 10M versions); the host builder it replaces held the GIL
   * for its whole pass too.  The streaming worker always releases:
   * its entire point is letting the apply loop make progress. */
  PyThreadState* _save_ts = nullptr;
  if (release_gil) _save_ts = PyEval_SaveThread();
  std::string user_key, prev_key;
  for (Py_ssize_t i = 0; i < n_in && !err.msg; i++) {
    const uint8_t* k = kp[i];
    Py_ssize_t klen = kl[i];
    Py_ssize_t off = prefix_skip;
    if (off >= klen || k[off] != 'x') { err.msg = "bad key mode"; break; }
    off += 1;
    if (mc_decode(k, klen - 8, &off, &user_key) < 0 || off != klen - 8) {
      err.msg = "bad memcomparable key";
      break;
    }
    uint64_t cts = ~be64(k + klen - 8);
    if (cts > safe_ts) safe_ts = cts;
    if (user_key.size() != 19 || user_key[0] != 't' ||
        user_key[9] != '_' || user_key[10] != 'r') {
      err.msg = "not a record key";     /* index keys: out of envelope */
      break;
    }
    const uint8_t* uk = reinterpret_cast<const uint8_t*>(user_key.data());
    int64_t tid = (int64_t)(be64(uk + 1) - kSignMask);
    if (handles.empty()) table_id = tid;
    else if (tid != table_id) { err.msg = "mixed tables"; break; }
    if (user_key != prev_key) {
      prev_key = user_key;
      handles.push_back((int64_t)(be64(uk + 11) - kSignMask));
      seg_start.push_back((int64_t)i);
    }
    seg_id[i] = (int32_t)(handles.size() - 1);
    commit_ts[i] = cts;

    const uint8_t* v = vp[i];
    Py_ssize_t vlen = vl[i];
    if (vlen < 2) { err.msg = "short write record"; break; }
    char wt = (char)v[0];
    Py_ssize_t voff = 1;
    uint64_t sts;
    if (read_varu64(v, vlen, &voff, &sts) < 0) {
      err.msg = "bad write start_ts";
      break;
    }
    start_ts[i] = sts;
    const uint8_t* sval = nullptr;
    uint64_t svlen = 0;
    while (voff < vlen) {
      char tag = (char)v[voff++];
      if (tag == 'v') {
        if (read_varu64(v, vlen, &voff, &svlen) < 0 ||
            voff + (Py_ssize_t)svlen > vlen) {
          err.msg = "bad short value";
          break;
        }
        sval = v + voff;
        voff += svlen;
      } else if (tag == 'R') {
        /* overlapped rollback marker on a committed write */
      } else {
        err.msg = "bad write tag";
        break;
      }
    }
    if (err.msg) break;
    uint8_t code;
    switch (wt) {
      case 'P': code = 0; break;
      case 'D': code = 1; break;
      case 'L': code = 2; break;
      case 'R': code = 3; break;
      default: err.msg = "bad write type"; code = 0; break;
    }
    if (err.msg) break;
    wtype[i] = code;
    if (code != 0) continue;            /* only PUTs carry row payloads */
    if (sval == nullptr) {
      need.push_back(NeedDefault{(int64_t)i, sts, user_key});
      continue;
    }
    has_payload[i] = 1;
    Py_ssize_t moff = 0;
    uint32_t pairs;
    if (mp_map_len(sval, (Py_ssize_t)svlen, &moff, &pairs) < 0) {
      err.msg = "bad row map";
      break;
    }
    for (uint32_t e = 0; e < pairs && !err.msg; e++) {
      MpVal cid, val;
      if (mp_read(sval, (Py_ssize_t)svlen, &moff, &cid) < 0 ||
          cid.type != MpVal::INT ||
          mp_read(sval, (Py_ssize_t)svlen, &moff, &val) < 0) {
        err.msg = "bad row datum";
        break;
      }
      Py_ssize_t c = 0;
      for (; c < ncols; c++)
        if (col_ids[c] == cid.i) break;
      if (c == ncols) {
        if (!discover || val.type == MpVal::NIL) continue;
        /* discovery: mint a plane on first sight, kind from the datum
         * (all-NIL columns never materialize — the consumer
         * synthesizes an invalid plane for them) */
        int kind;
        if (val.type == MpVal::INT) kind = 0;
        else if (val.type == MpVal::FLT) kind = 1;
        else { err.msg = "bytes col out of plane envelope"; break; }
        col_ids.push_back(cid.i);
        col_kinds.push_back(kind);
        planes.emplace_back();
        PlaneCol& np_ = planes.back();
        np_.kind = kind;
        np_.valid.assign(n_in, 0);
        if (kind == 1) np_.f64.assign(n_in, 0.0);
        else np_.i64.assign(n_in, 0);
        ncols = (Py_ssize_t)col_ids.size();
      }
      PlaneCol& pc = planes[c];
      if (val.type == MpVal::NIL) continue;
      switch (pc.kind) {
        case 0:
          if (val.type == MpVal::INT) pc.i64[i] = val.i;
          else if (val.type == MpVal::FLT) pc.i64[i] = (int64_t)val.f;
          else err.msg = "type mismatch int col";
          break;
        case 1:
          if (val.type == MpVal::FLT) pc.f64[i] = val.f;
          else if (val.type == MpVal::INT) pc.f64[i] = (double)val.i;
          else err.msg = "type mismatch real col";
          break;
        case 3:
          if (val.type == MpVal::INT) pc.u64[i] = (uint64_t)val.i;
          else err.msg = "type mismatch u64 col";
          break;
      }
      if (!err.msg) pc.valid[i] = 1;
    }
  }
  if (_save_ts) PyEval_RestoreThread(_save_ts);

  Py_DECREF(keys);
  Py_DECREF(vals);
  if (err.msg) return fail(err.msg);
  seg_start.push_back((int64_t)n_in);

  auto as_bytes = [](const void* p, size_t nbytes) {
    return PyByteArray_FromStringAndSize(
        reinterpret_cast<const char*>(p), (Py_ssize_t)nbytes);
  };
  PyObject* nd = PyList_New(0);
  if (!nd) return nullptr;
  for (auto& d : need) {
    PyObject* t = Py_BuildValue("LKy#", (long long)d.row,
                                (unsigned long long)d.start_ts,
                                d.ukey.data(), (Py_ssize_t)d.ukey.size());
    if (!t || PyList_Append(nd, t) < 0) {
      Py_XDECREF(t);
      Py_DECREF(nd);
      return nullptr;
    }
    Py_DECREF(t);
  }
  PyObject* out_cols = PyList_New(0);
  if (!out_cols) { Py_DECREF(nd); return nullptr; }
  for (Py_ssize_t c = 0; c < ncols; c++) {
    PlaneCol& pc = planes[c];
    PyObject* payload =
        pc.kind == 1 ? as_bytes(pc.f64.data(), (size_t)n_in * 8)
        : pc.kind == 3 ? as_bytes(pc.u64.data(), (size_t)n_in * 8)
                       : as_bytes(pc.i64.data(), (size_t)n_in * 8);
    PyObject* validity = as_bytes(pc.valid.data(), (size_t)n_in);
    PyObject* tup = (payload && validity)
        ? Py_BuildValue("(LiOO)", (long long)col_ids[c], pc.kind,
                        payload, validity)
        : nullptr;
    Py_XDECREF(payload);
    Py_XDECREF(validity);
    if (!tup || PyList_Append(out_cols, tup) < 0) {
      Py_XDECREF(tup);
      Py_DECREF(nd);
      Py_DECREF(out_cols);
      return nullptr;
    }
    Py_DECREF(tup);
  }
  Py_ssize_t n_keys = (Py_ssize_t)handles.size();
  PyObject* ret = Py_BuildValue(
      "{s:n,s:n,s:L,s:K,s:N,s:N,s:N,s:N,s:N,s:N,s:N,s:N,s:N}",
      "n_ver", n_in, "n_keys", n_keys, "table_id", (long long)table_id,
      "safe_ts", (unsigned long long)safe_ts,
      "commit_ts", as_bytes(commit_ts.data(), (size_t)n_in * 8),
      "start_ts", as_bytes(start_ts.data(), (size_t)n_in * 8),
      "wtype", as_bytes(wtype.data(), (size_t)n_in),
      "has_payload", as_bytes(has_payload.data(), (size_t)n_in),
      "seg_id", as_bytes(seg_id.data(), (size_t)n_in * 4),
      "handles", as_bytes(handles.data(), (size_t)n_keys * 8),
      "seg_start", as_bytes(seg_start.data(), (size_t)(n_keys + 1) * 8),
      "cols", out_cols, "need_default", nd);
  return ret;
}

/* crc64-xz (ECMA-182 reflected, check 0x995DC9BBDF1939FA — what the
 * reference's crc64fast computes), table-driven; XOR-folded over KV
 * pairs so the checksum is order-independent and composes across
 * regions (src/coprocessor/checksum.rs role). */
uint64_t g_crc64_table[256];
bool g_crc64_ready = false;

void crc64_init() {
  const uint64_t poly = 0xC96C5795D7870F42ULL;
  for (int i = 0; i < 256; i++) {
    uint64_t crc = (uint64_t)i;
    for (int b = 0; b < 8; b++)
      crc = (crc & 1) ? (crc >> 1) ^ poly : crc >> 1;
    g_crc64_table[i] = crc;
  }
  g_crc64_ready = true;
}

inline uint64_t crc64_update(uint64_t crc, const uint8_t* p,
                             Py_ssize_t n) {
  for (Py_ssize_t i = 0; i < n; i++)
    crc = (crc >> 8) ^ g_crc64_table[(crc ^ p[i]) & 0xFF];
  return crc;
}

PyObject* checksum_pairs(PyObject*, PyObject* args) {
  PyObject *keys_o, *vals_o;
  if (!PyArg_ParseTuple(args, "OO", &keys_o, &vals_o)) return nullptr;
  if (!g_crc64_ready) crc64_init();
  PyObject* keys = PySequence_Fast(keys_o, "keys not a sequence");
  if (!keys) return nullptr;
  PyObject* vals = PySequence_Fast(vals_o, "values not a sequence");
  if (!vals) { Py_DECREF(keys); return nullptr; }
  Py_ssize_t n = PySequence_Fast_GET_SIZE(keys);
  if (PySequence_Fast_GET_SIZE(vals) != n) {
    Py_DECREF(keys); Py_DECREF(vals);
    return fail("keys/values length mismatch");
  }
  uint64_t folded = 0;
  unsigned long long total_bytes = 0;
  for (Py_ssize_t i = 0; i < n; i++) {
    char *kp, *vp;
    Py_ssize_t klen, vlen;
    if (PyBytes_AsStringAndSize(PySequence_Fast_GET_ITEM(keys, i), &kp,
                                &klen) < 0 ||
        PyBytes_AsStringAndSize(PySequence_Fast_GET_ITEM(vals, i), &vp,
                                &vlen) < 0) {
      Py_DECREF(keys); Py_DECREF(vals);
      return nullptr;
    }
    uint64_t crc = ~0ULL;
    crc = crc64_update(crc, reinterpret_cast<const uint8_t*>(kp), klen);
    crc = crc64_update(crc, reinterpret_cast<const uint8_t*>(vp), vlen);
    folded ^= ~crc;
    total_bytes += (unsigned long long)(klen + vlen);
  }
  Py_DECREF(keys);
  Py_DECREF(vals);
  return Py_BuildValue("(KK)", (unsigned long long)folded, total_bytes);
}

/* ------------------------------------------------------------------ *
 * Bulk MVCC SST builder (client side of the ImportSST path).
 *
 * Reference role: TiDB Lightning / BR's native row encoder feeding
 * sst_importer (components/sst_importer/src/sst_writer.rs) — the
 * reference builds sorted SSTs in Rust at millions of rows/s; the
 * Python per-row encode path caps at ~80k rows/s, so bulk load gets
 * this native builder emitting the v2 SST container directly:
 *
 *   b"TKVSST2\n" + msgpack [[cf, [key...], [val...]], ...] + crc32(BE)
 *
 * Per row (formats mirror codec/number.py, codec/keys.py,
 * storage/txn_types.py Write.to_bytes / append_ts and codec/row.py's
 * msgpack envelope — all asserted byte-equal in tests):
 *   user_key = 't' + be64(table_id^2^63) + "_r" + be64(handle^2^63)
 *   enc      = 'x' + memcomparable(user_key)
 *   write-CF key = enc + be64(2^64-1 - commit_ts)
 *   payload  = msgpack {col_id: nil|int|double}
 *   short payloads inline:  'P' varu64(start_ts) 'v' varu64(len) payload
 *   long payloads split:    default-CF (enc + be64(~start_ts), payload)
 * ------------------------------------------------------------------ */

inline void put_be64(std::string* out, uint64_t v) {
  for (int i = 7; i >= 0; i--) out->push_back((char)((v >> (8 * i)) & 0xFF));
}

inline void put_be32(std::string* out, uint32_t v) {
  for (int i = 3; i >= 0; i--) out->push_back((char)((v >> (8 * i)) & 0xFF));
}

inline void put_varu64(std::string* out, uint64_t v) {
  while (v >= 0x80) {
    out->push_back((char)((v & 0x7F) | 0x80));
    v >>= 7;
  }
  out->push_back((char)v);
}

/* msgpack minimal int encode — byte-identical to msgpack-python packb */
inline void mp_put_int(std::string* out, int64_t v) {
  if (v >= 0) {
    uint64_t u = (uint64_t)v;
    if (u <= 0x7F) { out->push_back((char)u); }
    else if (u <= 0xFF) { out->push_back((char)0xCC); out->push_back((char)u); }
    else if (u <= 0xFFFF) { out->push_back((char)0xCD);
      out->push_back((char)(u >> 8)); out->push_back((char)(u & 0xFF)); }
    else if (u <= 0xFFFFFFFFULL) { out->push_back((char)0xCE); put_be32(out, (uint32_t)u); }
    else { out->push_back((char)0xCF); put_be64(out, u); }
  } else {
    if (v >= -32) { out->push_back((char)(int8_t)v); }
    else if (v >= -128) { out->push_back((char)0xD0); out->push_back((char)(int8_t)v); }
    else if (v >= -32768) { out->push_back((char)0xD1);
      out->push_back((char)(((uint16_t)(int16_t)v) >> 8));
      out->push_back((char)(((uint16_t)(int16_t)v) & 0xFF)); }
    else if (v >= -2147483648LL) { out->push_back((char)0xD2);
      put_be32(out, (uint32_t)(int32_t)v); }
    else { out->push_back((char)0xD3); put_be64(out, (uint64_t)v); }
  }
}

inline void mp_put_bin(std::string* out, const uint8_t* p, uint32_t n) {
  if (n <= 0xFF) { out->push_back((char)0xC4); out->push_back((char)n); }
  else if (n <= 0xFFFF) { out->push_back((char)0xC5);
    out->push_back((char)(n >> 8)); out->push_back((char)(n & 0xFF)); }
  else { out->push_back((char)0xC6); put_be32(out, n); }
  out->append(reinterpret_cast<const char*>(p), n);
}

inline void mc_encode(std::string* out, const uint8_t* p, Py_ssize_t n) {
  for (Py_ssize_t i = 0; i <= n; i += 8) {
    Py_ssize_t take = n - i < 8 ? n - i : 8;
    out->append(reinterpret_cast<const char*>(p) + i, take);
    for (Py_ssize_t j = take; j < 8; j++) out->push_back('\0');
    out->push_back((char)(0xFF - (8 - take)));
  }
}

/* crc32 (zlib polynomial, matches Python zlib.crc32) */
static uint32_t g_crc32_table[256];
static bool g_crc32_ready = false;
void crc32_init() {
  for (uint32_t i = 0; i < 256; i++) {
    uint32_t c = i;
    for (int k = 0; k < 8; k++)
      c = (c & 1) ? (0xEDB88320u ^ (c >> 1)) : (c >> 1);
    g_crc32_table[i] = c;
  }
  g_crc32_ready = true;
}

inline uint32_t crc32_buf(const uint8_t* p, size_t n) {
  if (!g_crc32_ready) crc32_init();
  uint32_t c = 0xFFFFFFFFu;
  for (size_t i = 0; i < n; i++)
    c = g_crc32_table[(c ^ p[i]) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

PyObject* build_mvcc_sst(PyObject*, PyObject* args) {
  /* (table_id, handles_i64_bytes, col_ids tuple, col_kinds tuple
     (0=int64,1=float64), col_bufs tuple of bytes, col_valid tuple of
     bytes-or-None, commit_ts, start_ts) -> v2 sst blob */
  long long table_id, commit_ts, start_ts;
  PyObject *handles_o, *ids_o, *kinds_o, *bufs_o, *valid_o;
  if (!PyArg_ParseTuple(args, "LOOOOOLL", &table_id, &handles_o, &ids_o,
                        &kinds_o, &bufs_o, &valid_o, &commit_ts,
                        &start_ts))
    return nullptr;
  char* hp;
  Py_ssize_t hlen;
  if (PyBytes_AsStringAndSize(handles_o, &hp, &hlen) < 0) return nullptr;
  Py_ssize_t n = hlen / 8;
  const int64_t* handles = reinterpret_cast<const int64_t*>(hp);
  Py_ssize_t ncols = PySequence_Size(ids_o);
  if (ncols > 0xFFFF) return fail("too many columns");   /* map16 limit */
  std::vector<int64_t> ids(ncols);
  std::vector<int> kinds(ncols);
  std::vector<const uint8_t*> bufs(ncols);
  std::vector<const uint8_t*> valid(ncols, nullptr);
  for (Py_ssize_t c = 0; c < ncols; c++) {
    PyObject* io = PySequence_GetItem(ids_o, c);
    PyObject* ko = PySequence_GetItem(kinds_o, c);
    ids[c] = PyLong_AsLongLong(io);
    kinds[c] = (int)PyLong_AsLong(ko);
    Py_XDECREF(io); Py_XDECREF(ko);
    PyObject* bo = PySequence_GetItem(bufs_o, c);
    char* bp; Py_ssize_t blen;
    if (PyBytes_AsStringAndSize(bo, &bp, &blen) < 0) {
      Py_XDECREF(bo); return nullptr;
    }
    if (blen < n * 8) { Py_XDECREF(bo); return fail("short column buffer"); }
    bufs[c] = reinterpret_cast<const uint8_t*>(bp);
    Py_XDECREF(bo);   /* caller keeps the bytes alive via the tuple */
    PyObject* vo = PySequence_GetItem(valid_o, c);
    if (vo != Py_None) {
      char* vp; Py_ssize_t vlen;
      if (PyBytes_AsStringAndSize(vo, &vp, &vlen) < 0) {
        Py_XDECREF(vo); return nullptr;
      }
      if (vlen < n) { Py_XDECREF(vo); return fail("short validity buffer"); }
      valid[c] = reinterpret_cast<const uint8_t*>(vp);
    }
    Py_XDECREF(vo);
  }

  const uint64_t TSMAX = ~0ULL;
  std::string wkeys, wvals, dkeys, dvals;   /* concatenated msgpack bins */
  wkeys.reserve((size_t)n * 40);
  wvals.reserve((size_t)n * 32);
  uint64_t n_w = 0, n_d = 0;
  std::string ukey, enc, payload, rec;
  /* the encode loop touches only the raw buffers snapshotted above
   * (the caller's tuples keep them alive), so it runs with the GIL
   * RELEASED: the bench loader's build-ahead thread encodes the next
   * chunk while the ingest RPC (and the server's parse/apply, in the
   * in-process test topology) make real progress — serializing them
   * was the measured loader ceiling. */
  Py_BEGIN_ALLOW_THREADS
  for (Py_ssize_t i = 0; i < n; i++) {
    ukey.clear();
    ukey.push_back('t');
    put_be64(&ukey, (uint64_t)table_id ^ 0x8000000000000000ULL);
    ukey.push_back('_'); ukey.push_back('r');
    put_be64(&ukey, (uint64_t)handles[i] ^ 0x8000000000000000ULL);
    enc.clear();
    enc.push_back('x');
    mc_encode(&enc, reinterpret_cast<const uint8_t*>(ukey.data()),
              (Py_ssize_t)ukey.size());
    payload.clear();
    if (ncols <= 15) {
      payload.push_back((char)(0x80 | (ncols & 0x0F)));
    } else {
      /* fixmap tops out at 15 entries; wider rows take map16 (0xDE),
         which mp_map_len and msgpack both decode */
      payload.push_back((char)0xDE);
      payload.push_back((char)((ncols >> 8) & 0xFF));
      payload.push_back((char)(ncols & 0xFF));
    }
    for (Py_ssize_t c = 0; c < ncols; c++) {
      mp_put_int(&payload, ids[c]);
      if (valid[c] && !valid[c][i]) {
        payload.push_back((char)0xC0);                /* nil */
      } else if (kinds[c] == 1) {
        payload.push_back((char)0xCB);                /* float64 */
        uint64_t u;
        std::memcpy(&u, bufs[c] + 8 * i, 8);
        put_be64(&payload, u);
      } else {
        int64_t v;
        std::memcpy(&v, bufs[c] + 8 * i, 8);
        mp_put_int(&payload, v);
      }
    }
    rec.clear();
    rec.push_back('P');
    put_varu64(&rec, (uint64_t)start_ts);
    if (payload.size() <= 255) {
      rec.push_back('v');
      put_varu64(&rec, (uint64_t)payload.size());
      rec += payload;
    } else {
      /* long value: payload rides the default CF at start_ts */
      std::string kd = enc;
      put_be64(&kd, TSMAX - (uint64_t)start_ts);
      mp_put_bin(&dkeys, reinterpret_cast<const uint8_t*>(kd.data()),
                 (uint32_t)kd.size());
      mp_put_bin(&dvals, reinterpret_cast<const uint8_t*>(payload.data()),
                 (uint32_t)payload.size());
      n_d++;
    }
    std::string kw = enc;
    put_be64(&kw, TSMAX - (uint64_t)commit_ts);
    mp_put_bin(&wkeys, reinterpret_cast<const uint8_t*>(kw.data()),
               (uint32_t)kw.size());
    mp_put_bin(&wvals, reinterpret_cast<const uint8_t*>(rec.data()),
               (uint32_t)rec.size());
    n_w++;
  }
  Py_END_ALLOW_THREADS

  /* payload: fixarray of [cf(fixstr), keys(array32), vals(array32)] */
  if (!g_crc32_ready) crc32_init();     /* init under the GIL */
  std::string body;
  std::string out;
  Py_BEGIN_ALLOW_THREADS
  body.reserve(wkeys.size() + wvals.size() + dkeys.size() + dvals.size()
               + 64);
  int groups = 1 + (n_d ? 1 : 0);
  body.push_back((char)(0x90 | groups));
  if (n_d) {        /* "default" sorts before "write" (v1 sorted by cf) */
    body.push_back((char)0x93);
    body.push_back((char)(0xA0 | 7));
    body.append("default");
    body.push_back((char)0xDD); put_be32(&body, (uint32_t)n_d);
    body += dkeys;
    body.push_back((char)0xDD); put_be32(&body, (uint32_t)n_d);
    body += dvals;
  }
  body.push_back((char)0x93);
  body.push_back((char)(0xA0 | 5));
  body.append("write");
  body.push_back((char)0xDD); put_be32(&body, (uint32_t)n_w);
  body += wkeys;
  body.push_back((char)0xDD); put_be32(&body, (uint32_t)n_w);
  body += wvals;

  out.reserve(body.size() + 16);
  out.append("TKVSST2\n");
  out += body;
  put_be32(&out, crc32_buf(reinterpret_cast<const uint8_t*>(body.data()),
                           body.size()));
  Py_END_ALLOW_THREADS
  return PyBytes_FromStringAndSize(out.data(), (Py_ssize_t)out.size());
}

PyMethodDef methods[] = {
    {"mvcc_build_columnar", mvcc_build, METH_VARARGS,
     "One-pass MVCC resolve + row decode into columnar buffers.\n"
     "(keys, values, read_ts, prefix_skip, col_ids, col_kinds) -> dict"},
    {"mvcc_parse_planes", mvcc_parse_planes, METH_VARARGS,
     "Flat-plane CF_WRITE parse for device-side MVCC resolution (GIL\n"
     "released in the core loop): (keys, values, prefix_skip, col_ids,\n"
     "col_kinds) -> dict of fixed-width planes + need_default"},
    {"checksum_pairs", checksum_pairs, METH_VARARGS,
     "XOR-folded crc64-xz over (key||value) pairs -> (checksum, bytes)"},
    {"build_mvcc_sst", build_mvcc_sst, METH_VARARGS,
     "Bulk pre-timestamped MVCC SST (v2 container) from int64/float64\n"
     "column buffers: (table_id, handles_bytes, col_ids, col_kinds,\n"
     "col_bufs, col_valid, commit_ts, start_ts) -> bytes"},
    {nullptr, nullptr, 0, nullptr}};

PyModuleDef moddef = {PyModuleDef_HEAD_INIT, "_fastbuild",
                      "native MVCC columnar builder", -1, methods,
                      nullptr, nullptr, nullptr, nullptr};

}  // namespace

PyMODINIT_FUNC PyInit__fastbuild(void) { return PyModule_Create(&moddef); }
