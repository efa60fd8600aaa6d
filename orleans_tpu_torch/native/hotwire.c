/* hotwire — native wire-tier codec for orleans_tpu_torch (L1 wire
 * serialization); the port's copy of orleans_tpu's hotwire.c.
 *
 * Re-design of the reference's binary token-stream serializer
 * (Orleans' src/Orleans.Core/Serialization/SerializationManager.cs:50,133
 * and BinaryTokenStreamWriter.cs) as a CPython C extension: a tagged
 * little-endian value codec specialized for the framework's message-header
 * types (GrainId / SiloAddress / ActivationId / ActivationAddress, scalars,
 * containers), with a per-value pickle escape hatch for anything else.
 *
 * Why native: the header tuple of every cross-process message rides this
 * codec.  The pickle path costs ~8us encode + ~12us decode per message
 * (restricted-unpickler find_class callbacks + reduce-protocol object
 * rebuilds); this codec does the same tuple in well under 1us each way and
 * removes pickle (and its attack surface) from the wire for all framework
 * types.  Bodies of scalars/arrays of scalars ride it too; arbitrary user
 * payloads fall back per-value to the configured (restricted) pickler.
 *
 * Wire format: [0xA7 magic][0x01 version][value]
 *   value := tag byte + payload (varint = unsigned LEB128; signed ints are
 *   zigzag-encoded).  Containers carry a count then nested values.  The
 *   id-type tags carry their fields positionally, including the precomputed
 *   64-bit uniform hash so decode never re-hashes.
 *
 * Safety: decode bounds-checks every read against the buffer, caps nesting
 * depth, and validates lengths before allocating.  Unknown tags and
 * truncated buffers raise ValueError — never crash, never read OOB.
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <stdint.h>
#include <string.h>
#ifndef MS_WINDOWS
#include <errno.h>
#include <sys/socket.h>
#include <sys/uio.h>
#include <netinet/in.h>
#include <arpa/inet.h>
#include <unistd.h>
#endif

#define HW_MAGIC 0xA7
#define HW_VERSION 0x01
#define HW_MAX_DEPTH 200

/* value tags */
enum {
    T_NONE = 0x00,
    T_TRUE = 0x01,
    T_FALSE = 0x02,
    T_INT = 0x03,      /* zigzag varint, fits int64 */
    T_FLOAT = 0x05,    /* 8-byte IEEE754 little-endian */
    T_STR = 0x06,      /* varint len + utf8 */
    T_BYTES = 0x07,    /* varint len + raw */
    T_TUPLE = 0x08,    /* varint count + values */
    T_LIST = 0x09,
    T_DICT = 0x0A,     /* varint count + key,value pairs */
    T_SET = 0x0B,
    T_FROZENSET = 0x0C,
    T_GRAIN_ID = 0x0D,       /* category varint, type_code varint, key value,
                                key_ext value, hash64 varint */
    T_SILO_ADDR = 0x0E,      /* host value(str), port varint, generation varint,
                                mesh_index zigzag varint, uh varint */
    T_ACTIVATION_ID = 0x0F,  /* value varint */
    T_ACTIVATION_ADDR = 0x10,/* silo value, grain value, activation value */
    T_PICKLE = 0x11,   /* varint len + pickle bytes (restricted loader) */
};

/* ------------------------------------------------------------------ */
/* module state: configured Python types + helpers                     */

typedef struct {
    PyObject *grain_id_cls;
    PyObject *grain_cat_members; /* tuple indexed by category value */
    PyObject *silo_cls;
    PyObject *act_id_cls;
    PyObject *act_addr_cls;
    PyObject *pickle_dumps;      /* callable(obj) -> bytes */
    PyObject *pickle_loads;      /* callable(bytes) -> obj (restricted) */
    /* interned field-name strings for fast instance-dict fills */
    PyObject *s_category, *s_type_code, *s_key, *s_key_ext, *s_hash64;
    PyObject *s_host, *s_port, *s_generation, *s_mesh_index, *s_uh;
    PyObject *s_value, *s_silo, *s_grain, *s_activation;
    int configured;
    /* message-header struct spec (configure_headers): the field-name
     * tuple and enum restore spec cached module-side, so the per-message
     * socket path passes only (msg, ttl, body) — no Python-level spec
     * marshalling per frame. */
    PyObject *hdr_names;         /* tuple of str */
    PyObject *hdr_enum_spec;     /* tuple of (index, members) pairs */
    int hdr_configured;
} hw_state;

static hw_state g_state;  /* single-interpreter module; kept simple */

/* ------------------------------------------------------------------ */
/* growable write buffer                                               */

typedef struct {
    char *buf;
    Py_ssize_t len, cap;
} W;

static int w_init(W *w, Py_ssize_t cap) {
    w->buf = PyMem_Malloc(cap);
    if (!w->buf) { PyErr_NoMemory(); return -1; }
    w->len = 0; w->cap = cap;
    return 0;
}

static void w_free(W *w) { PyMem_Free(w->buf); w->buf = NULL; }

static int w_grow(W *w, Py_ssize_t need) {
    Py_ssize_t cap = w->cap;
    while (cap - w->len < need) cap += cap > (1<<20) ? (1<<20) : cap;
    char *nb = PyMem_Realloc(w->buf, cap);
    if (!nb) { PyErr_NoMemory(); return -1; }
    w->buf = nb; w->cap = cap;
    return 0;
}

static inline int w_byte(W *w, uint8_t b) {
    if (w->cap - w->len < 1 && w_grow(w, 1) < 0) return -1;
    w->buf[w->len++] = (char)b;
    return 0;
}

static inline int w_raw(W *w, const char *p, Py_ssize_t n) {
    if (w->cap - w->len < n && w_grow(w, n) < 0) return -1;
    memcpy(w->buf + w->len, p, n);
    w->len += n;
    return 0;
}

static int w_varint(W *w, uint64_t v) {
    uint8_t tmp[10]; int n = 0;
    do { uint8_t b = v & 0x7F; v >>= 7; if (v) b |= 0x80; tmp[n++] = b; } while (v);
    return w_raw(w, (char *)tmp, n);
}

static inline uint64_t zigzag(int64_t v) {
    return ((uint64_t)v << 1) ^ (uint64_t)(v >> 63);
}
static inline int64_t unzigzag(uint64_t v) {
    return (int64_t)(v >> 1) ^ -(int64_t)(v & 1);
}

/* ------------------------------------------------------------------ */
/* encoder                                                             */

static int enc_value(W *w, PyObject *obj, int depth);

/* Escape one value through the configured restricted pickler. */
static int enc_pickle(W *w, PyObject *obj) {
    if (!g_state.configured) {
        PyErr_SetString(PyExc_RuntimeError, "hotwire: not configured");
        return -1;
    }
    PyObject *data = PyObject_CallOneArg(g_state.pickle_dumps, obj);
    if (!data) return -1;
    char *p; Py_ssize_t n;
    if (PyBytes_AsStringAndSize(data, &p, &n) < 0) { Py_DECREF(data); return -1; }
    int rc = (w_byte(w, T_PICKLE) < 0 || w_varint(w, (uint64_t)n) < 0 ||
              w_raw(w, p, n) < 0) ? -1 : 0;
    Py_DECREF(data);
    return rc;
}

static int enc_str_payload(W *w, PyObject *s) {
    Py_ssize_t n;
    const char *p = PyUnicode_AsUTF8AndSize(s, &n);
    if (!p) return -1;
    if (w_varint(w, (uint64_t)n) < 0) return -1;
    return w_raw(w, p, n);
}

/* dig a field out of a (frozen-dataclass) instance */
static PyObject *get_field(PyObject *obj, PyObject *name) {
    return PyObject_GetAttr(obj, name);
}

static int enc_int_field(W *w, PyObject *obj, PyObject *name) {
    PyObject *v = get_field(obj, name);
    if (!v) return -1;
    int overflow = 0;
    long long ll = PyLong_AsLongLongAndOverflow(v, &overflow);
    Py_DECREF(v);
    if (overflow || (ll == -1 && PyErr_Occurred())) {
        if (!PyErr_Occurred())
            PyErr_SetString(PyExc_OverflowError, "id field exceeds int64");
        return -1;
    }
    return w_varint(w, zigzag(ll));
}

static int enc_obj_field(W *w, PyObject *obj, PyObject *name, int depth) {
    PyObject *v = get_field(obj, name);
    if (!v) return -1;
    int rc = enc_value(w, v, depth);
    Py_DECREF(v);
    return rc;
}

static int enc_value(W *w, PyObject *obj, int depth) {
    if (depth > HW_MAX_DEPTH) {
        PyErr_SetString(PyExc_ValueError, "hotwire: nesting too deep");
        return -1;
    }
    if (obj == Py_None) return w_byte(w, T_NONE);
    if (obj == Py_True) return w_byte(w, T_TRUE);
    if (obj == Py_False) return w_byte(w, T_FALSE);

    PyTypeObject *t = Py_TYPE(obj);

    if (t == &PyLong_Type) {
        int overflow = 0;
        long long ll = PyLong_AsLongLongAndOverflow(obj, &overflow);
        if (overflow) return enc_pickle(w, obj);  /* bignum: rare */
        if (ll == -1 && PyErr_Occurred()) return -1;
        if (w_byte(w, T_INT) < 0) return -1;
        return w_varint(w, zigzag(ll));
    }
    if (t == &PyFloat_Type) {
        double d = PyFloat_AS_DOUBLE(obj);
        uint64_t bits;
        memcpy(&bits, &d, 8);
#if PY_BIG_ENDIAN
        bits = __builtin_bswap64(bits);
#endif
        if (w_byte(w, T_FLOAT) < 0) return -1;
        return w_raw(w, (char *)&bits, 8);
    }
    if (t == &PyUnicode_Type) {
        Py_ssize_t n;
        const char *p = PyUnicode_AsUTF8AndSize(obj, &n);
        if (!p) {  /* lone surrogates etc: escape */
            PyErr_Clear();
            return enc_pickle(w, obj);
        }
        if (w_byte(w, T_STR) < 0 || w_varint(w, (uint64_t)n) < 0) return -1;
        return w_raw(w, p, n);
    }
    if (t == &PyBytes_Type) {
        char *p; Py_ssize_t n;
        PyBytes_AsStringAndSize(obj, &p, &n);
        if (w_byte(w, T_BYTES) < 0 || w_varint(w, (uint64_t)n) < 0) return -1;
        return w_raw(w, p, n);
    }
    if (t == &PyTuple_Type) {
        Py_ssize_t n = PyTuple_GET_SIZE(obj);
        if (w_byte(w, T_TUPLE) < 0) return -1;
        if (w_varint(w, (uint64_t)n) < 0) return -1;
        for (Py_ssize_t i = 0; i < n; i++) {
            /* tuples are immutable: items cannot move under us */
            if (enc_value(w, PyTuple_GET_ITEM(obj, i), depth + 1) < 0)
                return -1;
        }
        return 0;
    }
    if (t == &PyList_Type) {
        /* a nested pickle escape can run arbitrary __reduce__ code that
           mutates this list mid-encode: hold each item and re-check the
           size every step so we never read out of bounds, and reject the
           frame on mutation (the emitted count is already committed) */
        Py_ssize_t n = PyList_GET_SIZE(obj);
        if (w_byte(w, T_LIST) < 0) return -1;
        if (w_varint(w, (uint64_t)n) < 0) return -1;
        for (Py_ssize_t i = 0; i < n; i++) {
            if (PyList_GET_SIZE(obj) != n) {
                PyErr_SetString(PyExc_ValueError,
                                "hotwire: list mutated during encode");
                return -1;
            }
            PyObject *it = PyList_GET_ITEM(obj, i);
            Py_INCREF(it);
            int rc = enc_value(w, it, depth + 1);
            Py_DECREF(it);
            if (rc < 0) return -1;
        }
        return 0;
    }
    if (t == &PyDict_Type) {
        /* snapshot: PyDict_Next over a dict that a nested pickle escape
           resizes is undefined behavior */
        PyObject *items = PyDict_Items(obj);
        if (!items) return -1;
        Py_ssize_t n = PyList_GET_SIZE(items);
        if (w_byte(w, T_DICT) < 0 || w_varint(w, (uint64_t)n) < 0) {
            Py_DECREF(items);
            return -1;
        }
        for (Py_ssize_t i = 0; i < n; i++) {
            PyObject *pair = PyList_GET_ITEM(items, i);
            if (enc_value(w, PyTuple_GET_ITEM(pair, 0), depth + 1) < 0 ||
                enc_value(w, PyTuple_GET_ITEM(pair, 1), depth + 1) < 0) {
                Py_DECREF(items);
                return -1;
            }
        }
        Py_DECREF(items);
        return 0;
    }
    if (t == &PySet_Type || t == &PyFrozenSet_Type) {
        if (w_byte(w, t == &PySet_Type ? T_SET : T_FROZENSET) < 0) return -1;
        if (w_varint(w, (uint64_t)PySet_GET_SIZE(obj)) < 0) return -1;
        PyObject *it = PyObject_GetIter(obj);
        if (!it) return -1;
        PyObject *item;
        while ((item = PyIter_Next(it))) {
            int rc = enc_value(w, item, depth + 1);
            Py_DECREF(item);
            if (rc < 0) { Py_DECREF(it); return -1; }
        }
        Py_DECREF(it);
        return PyErr_Occurred() ? -1 : 0;
    }

    if (g_state.configured) {
        if ((PyObject *)t == g_state.grain_id_cls) {
            if (w_byte(w, T_GRAIN_ID) < 0) return -1;
            if (enc_int_field(w, obj, g_state.s_category) < 0) return -1;
            if (enc_int_field(w, obj, g_state.s_type_code) < 0) return -1;
            if (enc_obj_field(w, obj, g_state.s_key, depth + 1) < 0) return -1;
            if (enc_obj_field(w, obj, g_state.s_key_ext, depth + 1) < 0) return -1;
            return enc_int_field(w, obj, g_state.s_hash64);
        }
        if ((PyObject *)t == g_state.silo_cls) {
            if (w_byte(w, T_SILO_ADDR) < 0) return -1;
            PyObject *host = get_field(obj, g_state.s_host);
            if (!host) return -1;
            int rc = enc_str_payload(w, host);
            Py_DECREF(host);
            if (rc < 0) return -1;
            if (enc_int_field(w, obj, g_state.s_port) < 0) return -1;
            if (enc_int_field(w, obj, g_state.s_generation) < 0) return -1;
            if (enc_int_field(w, obj, g_state.s_mesh_index) < 0) return -1;
            return enc_int_field(w, obj, g_state.s_uh);
        }
        if ((PyObject *)t == g_state.act_id_cls) {
            if (w_byte(w, T_ACTIVATION_ID) < 0) return -1;
            return enc_int_field(w, obj, g_state.s_value);
        }
        if ((PyObject *)t == g_state.act_addr_cls) {
            if (w_byte(w, T_ACTIVATION_ADDR) < 0) return -1;
            if (enc_obj_field(w, obj, g_state.s_silo, depth + 1) < 0) return -1;
            if (enc_obj_field(w, obj, g_state.s_grain, depth + 1) < 0) return -1;
            return enc_obj_field(w, obj, g_state.s_activation, depth + 1);
        }
    }
    /* anything else (enums, user dataclasses, exceptions, ndarrays):
       per-value restricted-pickle escape */
    return enc_pickle(w, obj);
}

/* ------------------------------------------------------------------ */
/* decoder                                                             */

typedef struct {
    const uint8_t *p, *end;
} R;

static int r_need(R *r, Py_ssize_t n) {
    if (r->end - r->p < n) {
        PyErr_SetString(PyExc_ValueError, "hotwire: truncated buffer");
        return -1;
    }
    return 0;
}

static int r_varint(R *r, uint64_t *out) {
    uint64_t v = 0; int shift = 0;
    while (1) {
        if (r_need(r, 1) < 0) return -1;
        uint8_t b = *r->p++;
        /* at shift 63 only the low payload bit fits in uint64; higher bits
           would silently truncate, so reject them too */
        if (shift >= 64 || (shift == 63 && (b & 0x7E))) {
            PyErr_SetString(PyExc_ValueError, "hotwire: varint overflow");
            return -1;
        }
        v |= (uint64_t)(b & 0x7F) << shift;
        if (!(b & 0x80)) break;
        shift += 7;
    }
    *out = v;
    return 0;
}

/* read a length varint and validate it against the remaining buffer;
   rejects values that would go negative when cast to Py_ssize_t */
static int r_len(R *r, Py_ssize_t *out) {
    uint64_t n;
    if (r_varint(r, &n) < 0) return -1;
    if (n > (uint64_t)(r->end - r->p)) {
        PyErr_SetString(PyExc_ValueError, "hotwire: truncated buffer");
        return -1;
    }
    *out = (Py_ssize_t)n;
    return 0;
}

static PyObject *dec_value(R *r, int depth);

static int dec_i64(R *r, int64_t *out) {
    uint64_t raw;
    if (r_varint(r, &raw) < 0) return -1;
    *out = unzigzag(raw);
    return 0;
}

/* build an instance of a plain Python class without running __init__:
   cls.__new__(cls), then fill fields via the generic attr machinery
   (bypasses the frozen-dataclass __setattr__ override by design). */
static PyObject *empty_args;  /* cached () for tp_new */

static PyObject *blank_instance(PyObject *cls) {
    return ((PyTypeObject *)cls)->tp_new((PyTypeObject *)cls, empty_args, NULL);
}

static int set_field(PyObject *inst, PyObject *name, PyObject *val) {
    /* val is stolen on success-or-failure for caller convenience */
    int rc = PyObject_GenericSetAttr(inst, name, val);
    Py_DECREF(val);
    return rc;
}

static int set_i64_field(PyObject *inst, PyObject *name, int64_t v) {
    PyObject *o = PyLong_FromLongLong(v);
    if (!o) return -1;
    return set_field(inst, name, o);
}

static PyObject *dec_value(R *r, int depth) {
    if (depth > HW_MAX_DEPTH) {
        PyErr_SetString(PyExc_ValueError, "hotwire: nesting too deep");
        return NULL;
    }
    if (r_need(r, 1) < 0) return NULL;
    uint8_t tag = *r->p++;
    switch (tag) {
    case T_NONE: Py_RETURN_NONE;
    case T_TRUE: Py_RETURN_TRUE;
    case T_FALSE: Py_RETURN_FALSE;
    case T_INT: {
        int64_t v;
        if (dec_i64(r, &v) < 0) return NULL;
        return PyLong_FromLongLong(v);
    }
    case T_FLOAT: {
        if (r_need(r, 8) < 0) return NULL;
        uint64_t bits;
        memcpy(&bits, r->p, 8);
        r->p += 8;
#if PY_BIG_ENDIAN
        bits = __builtin_bswap64(bits);
#endif
        double d;
        memcpy(&d, &bits, 8);
        return PyFloat_FromDouble(d);
    }
    case T_STR: {
        Py_ssize_t n;
        if (r_len(r, &n) < 0) return NULL;
        PyObject *s = PyUnicode_DecodeUTF8((const char *)r->p, n, NULL);
        if (s) r->p += n;
        return s;
    }
    case T_BYTES: {
        Py_ssize_t n;
        if (r_len(r, &n) < 0) return NULL;
        PyObject *b = PyBytes_FromStringAndSize((const char *)r->p, n);
        if (b) r->p += n;
        return b;
    }
    case T_TUPLE: case T_LIST: {
        /* each element takes >=1 byte, so r_len's remaining-buffer bound
           also caps the count before allocating */
        Py_ssize_t n;
        if (r_len(r, &n) < 0) return NULL;
        PyObject *c = tag == T_TUPLE ? PyTuple_New(n) : PyList_New(n);
        if (!c) return NULL;
        for (Py_ssize_t i = 0; i < n; i++) {
            PyObject *v = dec_value(r, depth + 1);
            if (!v) { Py_DECREF(c); return NULL; }
            if (tag == T_TUPLE) PyTuple_SET_ITEM(c, i, v);
            else PyList_SET_ITEM(c, i, v);
        }
        return c;
    }
    case T_DICT: {
        Py_ssize_t n;
        if (r_len(r, &n) < 0) return NULL;
        PyObject *d = PyDict_New();
        if (!d) return NULL;
        for (Py_ssize_t i = 0; i < n; i++) {
            PyObject *k = dec_value(r, depth + 1);
            if (!k) { Py_DECREF(d); return NULL; }
            PyObject *v = dec_value(r, depth + 1);
            if (!v) { Py_DECREF(k); Py_DECREF(d); return NULL; }
            int rc = PyDict_SetItem(d, k, v);
            Py_DECREF(k); Py_DECREF(v);
            if (rc < 0) { Py_DECREF(d); return NULL; }
        }
        return d;
    }
    case T_SET: case T_FROZENSET: {
        Py_ssize_t n;
        if (r_len(r, &n) < 0) return NULL;
        PyObject *s = tag == T_SET ? PySet_New(NULL) : PyFrozenSet_New(NULL);
        if (!s) return NULL;
        for (Py_ssize_t i = 0; i < n; i++) {
            PyObject *v = dec_value(r, depth + 1);
            if (!v) { Py_DECREF(s); return NULL; }
            int rc = PySet_Add(s, v);
            Py_DECREF(v);
            if (rc < 0) { Py_DECREF(s); return NULL; }
        }
        return s;
    }
    case T_GRAIN_ID: {
        if (!g_state.configured) goto unconfigured;
        int64_t cat, tc, h64;
        if (dec_i64(r, &cat) < 0) return NULL;
        if (dec_i64(r, &tc) < 0) return NULL;
        PyObject *key = dec_value(r, depth + 1);
        if (!key) return NULL;
        PyObject *ext = dec_value(r, depth + 1);
        if (!ext) { Py_DECREF(key); return NULL; }
        if (dec_i64(r, &h64) < 0) { Py_DECREF(key); Py_DECREF(ext); return NULL; }
        if (cat < 0 || cat >= PyTuple_GET_SIZE(g_state.grain_cat_members) ||
            PyTuple_GET_ITEM(g_state.grain_cat_members, cat) == Py_None) {
            Py_DECREF(key); Py_DECREF(ext);
            PyErr_Format(PyExc_ValueError, "hotwire: bad grain category %lld",
                         (long long)cat);
            return NULL;
        }
        PyObject *inst = blank_instance(g_state.grain_id_cls);
        if (!inst) { Py_DECREF(key); Py_DECREF(ext); return NULL; }
        PyObject *catm = PyTuple_GET_ITEM(g_state.grain_cat_members, cat);
        Py_INCREF(catm);
        /* set_field steals its value, so a short-circuited chain would
         * leak the owned objects it never reached — consume them
         * explicitly on each early-failure branch */
        if (set_field(inst, g_state.s_category, catm) < 0 ||
            set_i64_field(inst, g_state.s_type_code, tc) < 0) {
            Py_DECREF(key); Py_DECREF(ext); Py_DECREF(inst);
            return NULL;
        }
        if (set_field(inst, g_state.s_key, key) < 0) {
            Py_DECREF(ext); Py_DECREF(inst);
            return NULL;
        }
        if (set_field(inst, g_state.s_key_ext, ext) < 0 ||
            set_i64_field(inst, g_state.s_hash64, h64) < 0) {
            Py_DECREF(inst);
            return NULL;
        }
        return inst;
    }
    case T_SILO_ADDR: {
        if (!g_state.configured) goto unconfigured;
        Py_ssize_t hn;
        if (r_len(r, &hn) < 0) return NULL;
        PyObject *host = PyUnicode_DecodeUTF8((const char *)r->p, hn, NULL);
        if (!host) return NULL;
        r->p += hn;
        int64_t port, gen, mesh, uh;
        if (dec_i64(r, &port) < 0 || dec_i64(r, &gen) < 0 ||
            dec_i64(r, &mesh) < 0 || dec_i64(r, &uh) < 0) {
            Py_DECREF(host);
            return NULL;
        }
        PyObject *inst = blank_instance(g_state.silo_cls);
        if (!inst) { Py_DECREF(host); return NULL; }
        if (set_field(inst, g_state.s_host, host) < 0 ||
            set_i64_field(inst, g_state.s_port, port) < 0 ||
            set_i64_field(inst, g_state.s_generation, gen) < 0 ||
            set_i64_field(inst, g_state.s_mesh_index, mesh) < 0 ||
            set_i64_field(inst, g_state.s_uh, uh) < 0) {
            Py_DECREF(inst);
            return NULL;
        }
        return inst;
    }
    case T_ACTIVATION_ID: {
        if (!g_state.configured) goto unconfigured;
        int64_t v;
        if (dec_i64(r, &v) < 0) return NULL;
        PyObject *inst = blank_instance(g_state.act_id_cls);
        if (!inst) return NULL;
        if (set_i64_field(inst, g_state.s_value, v) < 0) { Py_DECREF(inst); return NULL; }
        return inst;
    }
    case T_ACTIVATION_ADDR: {
        if (!g_state.configured) goto unconfigured;
        PyObject *silo = dec_value(r, depth + 1);
        if (!silo) return NULL;
        PyObject *grain = dec_value(r, depth + 1);
        if (!grain) { Py_DECREF(silo); return NULL; }
        PyObject *act = dec_value(r, depth + 1);
        if (!act) { Py_DECREF(silo); Py_DECREF(grain); return NULL; }
        PyObject *inst = blank_instance(g_state.act_addr_cls);
        if (!inst) { Py_DECREF(silo); Py_DECREF(grain); Py_DECREF(act); return NULL; }
        /* consume not-yet-stolen values on early failure (see T_GRAIN_ID) */
        if (set_field(inst, g_state.s_silo, silo) < 0) {
            Py_DECREF(grain); Py_DECREF(act); Py_DECREF(inst);
            return NULL;
        }
        if (set_field(inst, g_state.s_grain, grain) < 0) {
            Py_DECREF(act); Py_DECREF(inst);
            return NULL;
        }
        if (set_field(inst, g_state.s_activation, act) < 0) {
            Py_DECREF(inst);
            return NULL;
        }
        return inst;
    }
    case T_PICKLE: {
        if (!g_state.configured) goto unconfigured;
        Py_ssize_t n;
        if (r_len(r, &n) < 0) return NULL;
        PyObject *b = PyBytes_FromStringAndSize((const char *)r->p, n);
        if (!b) return NULL;
        r->p += n;
        PyObject *v = PyObject_CallOneArg(g_state.pickle_loads, b);
        Py_DECREF(b);
        return v;
    }
    default:
        PyErr_Format(PyExc_ValueError, "hotwire: unknown tag 0x%02x", tag);
        return NULL;
    unconfigured:
        PyErr_SetString(PyExc_RuntimeError, "hotwire: not configured");
        return NULL;
    }
}

/* ------------------------------------------------------------------ */
/* module functions                                                    */

static PyObject *hw_dumps(PyObject *self, PyObject *obj) {
    W w;
    if (w_init(&w, 256) < 0) return NULL;
    w.buf[w.len++] = (char)(uint8_t)HW_MAGIC;
    w.buf[w.len++] = (char)HW_VERSION;
    if (enc_value(&w, obj, 0) < 0) { w_free(&w); return NULL; }
    PyObject *out = PyBytes_FromStringAndSize(w.buf, w.len);
    w_free(&w);
    return out;
}

static PyObject *hw_loads(PyObject *self, PyObject *arg) {
    Py_buffer view;
    if (PyObject_GetBuffer(arg, &view, PyBUF_SIMPLE) < 0) return NULL;
    R r = { (const uint8_t *)view.buf, (const uint8_t *)view.buf + view.len };
    PyObject *out = NULL;
    if (view.len < 2) {
        PyErr_SetString(PyExc_ValueError, "hotwire: buffer too short");
    } else if (r.p[0] != HW_MAGIC || r.p[1] != HW_VERSION) {
        PyErr_SetString(PyExc_ValueError, "hotwire: bad magic/version");
    } else {
        r.p += 2;
        out = dec_value(&r, 0);
        if (out && r.p != r.end) {
            Py_CLEAR(out);
            PyErr_SetString(PyExc_ValueError, "hotwire: trailing garbage");
        }
    }
    PyBuffer_Release(&view);
    return out;
}

static PyObject *hw_configure(PyObject *self, PyObject *args) {
    PyObject *grain_cls, *cat_members, *silo_cls, *act_cls, *addr_cls,
             *dumps_fn, *loads_fn;
    if (!PyArg_ParseTuple(args, "OOOOOOO", &grain_cls, &cat_members,
                          &silo_cls, &act_cls, &addr_cls, &dumps_fn, &loads_fn))
        return NULL;
    if (!PyTuple_Check(cat_members)) {
        PyErr_SetString(PyExc_TypeError, "cat_members must be a tuple");
        return NULL;
    }
    hw_state *s = &g_state;
#define KEEP(dst, src) do { Py_INCREF(src); Py_XSETREF(dst, src); } while (0)
    KEEP(s->grain_id_cls, grain_cls);
    KEEP(s->grain_cat_members, cat_members);
    KEEP(s->silo_cls, silo_cls);
    KEEP(s->act_id_cls, act_cls);
    KEEP(s->act_addr_cls, addr_cls);
    KEEP(s->pickle_dumps, dumps_fn);
    KEEP(s->pickle_loads, loads_fn);
#undef KEEP
#define INTERN(dst, name) do { \
        if (!dst) { dst = PyUnicode_InternFromString(name); \
                    if (!dst) return NULL; } } while (0)
    INTERN(s->s_category, "category");
    INTERN(s->s_type_code, "type_code");
    INTERN(s->s_key, "key");
    INTERN(s->s_key_ext, "key_ext");
    INTERN(s->s_hash64, "_hash64");
    INTERN(s->s_host, "host");
    INTERN(s->s_port, "port");
    INTERN(s->s_generation, "generation");
    INTERN(s->s_mesh_index, "mesh_index");
    INTERN(s->s_uh, "_uh");
    INTERN(s->s_value, "value");
    INTERN(s->s_silo, "silo");
    INTERN(s->s_grain, "grain");
    INTERN(s->s_activation, "activation");
#undef INTERN
    s->configured = 1;
    Py_RETURN_NONE;
}

/* Encode one already-fetched header-field value: top-level int
 * subclasses (IntEnums) are coerced to plain ints — the message-header
 * fast path; the decoder side restores them positionally.  Shared by
 * enc_attr_tuple and the template writer. */
static int enc_attr_value(W *w, PyObject *v) {
    if (PyLong_Check(v) && !PyLong_CheckExact(v) && !PyBool_Check(v)) {
        /* IntEnum header field -> wire int */
        int overflow = 0;
        long long ll = PyLong_AsLongLongAndOverflow(v, &overflow);
        if (overflow || (ll == -1 && PyErr_Occurred()))
            return -1;
        return (w_byte(w, T_INT) < 0 ||
                w_varint(w, zigzag(ll)) < 0) ? -1 : 0;
    }
    return enc_value(w, v, 1);
}

/* Shared core of pack_attrs/pack_frame: magic+version+T_TUPLE, then
 * tuple(getattr(obj, n) for n in names) + (extra,) without materializing
 * the intermediate tuple. */
static int enc_attr_tuple(W *w, PyObject *obj, PyObject *names,
                          PyObject *extra) {
    Py_ssize_t n = PyTuple_GET_SIZE(names);
    if (w->cap - w->len < 2 && w_grow(w, 2) < 0) return -1;
    w->buf[w->len++] = (char)(uint8_t)HW_MAGIC;
    w->buf[w->len++] = (char)HW_VERSION;
    if (w_byte(w, T_TUPLE) < 0 || w_varint(w, (uint64_t)(n + 1)) < 0)
        return -1;
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject *v = PyObject_GetAttr(obj, PyTuple_GET_ITEM(names, i));
        if (!v) return -1;
        int rc = enc_attr_value(w, v);
        Py_DECREF(v);
        if (rc < 0) return -1;
    }
    return enc_value(w, extra, 1);
}

/* pack_attrs(obj, names, extra) -> bytes */
static PyObject *hw_pack_attrs(PyObject *self, PyObject *args) {
    PyObject *obj, *names, *extra;
    if (!PyArg_ParseTuple(args, "OO!O", &obj, &PyTuple_Type, &names, &extra))
        return NULL;
    W w;
    if (w_init(&w, 256) < 0) return NULL;
    if (enc_attr_tuple(&w, obj, names, extra) < 0) { w_free(&w); return NULL; }
    PyObject *out = PyBytes_FromStringAndSize(w.buf, w.len);
    w_free(&w);
    return out;
}

/* frame segment cap, mirrored from runtime.wire.MAX_FRAME_SEGMENT */
#define HW_MAX_SEGMENT (128u * 1024u * 1024u)

/* configure_headers(names, enum_spec) -> None
 *
 * Caches the Message header-struct spec module-side: the field-name tuple
 * (interned for fast get/setattr) and the enum restore spec, so the
 * per-frame socket path (pack_frame/unpack_header) passes no spec
 * objects. */
static PyObject *hw_configure_headers(PyObject *self, PyObject *args) {
    PyObject *names, *enum_spec;
    if (!PyArg_ParseTuple(args, "O!O!", &PyTuple_Type, &names,
                          &PyTuple_Type, &enum_spec))
        return NULL;
    for (Py_ssize_t i = 0; i < PyTuple_GET_SIZE(names); i++) {
        if (!PyUnicode_Check(PyTuple_GET_ITEM(names, i))) {
            PyErr_SetString(PyExc_TypeError, "names must be strings");
            return NULL;
        }
    }
    for (Py_ssize_t e = 0; e < PyTuple_GET_SIZE(enum_spec); e++) {
        PyObject *pair = PyTuple_GET_ITEM(enum_spec, e);
        if (!PyTuple_Check(pair) || PyTuple_GET_SIZE(pair) != 2 ||
            !PyLong_Check(PyTuple_GET_ITEM(pair, 0)) ||
            !PyTuple_Check(PyTuple_GET_ITEM(pair, 1))) {
            PyErr_SetString(PyExc_TypeError,
                            "enum_spec: want (index, members) pairs");
            return NULL;
        }
    }
    /* intern the names in place for fast attribute access */
    PyObject *interned = PyTuple_New(PyTuple_GET_SIZE(names));
    if (!interned) return NULL;
    for (Py_ssize_t i = 0; i < PyTuple_GET_SIZE(names); i++) {
        PyObject *s = PyTuple_GET_ITEM(names, i);
        Py_INCREF(s);
        PyUnicode_InternInPlace(&s);
        PyTuple_SET_ITEM(interned, i, s);
    }
    Py_XSETREF(g_state.hdr_names, interned);
    Py_INCREF(enum_spec);
    Py_XSETREF(g_state.hdr_enum_spec, enum_spec);
    g_state.hdr_configured = 1;
    Py_RETURN_NONE;
}

/* Append one length-prefixed frame ([u32 hlen][u32 blen][headers][body])
 * at the current write position.  Shared by pack_frame (one frame per
 * call) and pack_batch (a whole send batch into one buffer) — the batch
 * output is bit-for-bit the concatenation of the per-frame outputs. */
static int frame_begin(W *w, Py_ssize_t *start, Py_buffer *body) {
    if (body->len > (Py_ssize_t)HW_MAX_SEGMENT) {
        PyErr_SetString(PyExc_ValueError, "hotwire: body exceeds frame cap");
        return -1;
    }
    *start = w->len;
    if (w->cap - w->len < 8 && w_grow(w, 8) < 0) return -1;
    memset(w->buf + *start, 0, 8);  /* length prefix backfilled at finish */
    w->len = *start + 8;
    return 0;
}

static int frame_finish(W *w, Py_ssize_t start, Py_buffer *body) {
    if (w->len - start - 8 > (Py_ssize_t)HW_MAX_SEGMENT) {
        PyErr_SetString(PyExc_ValueError,
                        "hotwire: headers exceed frame cap");
        return -1;
    }
    {
        uint32_t hlen = (uint32_t)(w->len - start - 8);
        uint32_t blen = (uint32_t)body->len;
        /* little-endian u32 pair, matching struct.Struct("<II") */
        char *p = w->buf + start;
        p[0] = (char)(hlen & 0xFF);
        p[1] = (char)((hlen >> 8) & 0xFF);
        p[2] = (char)((hlen >> 16) & 0xFF);
        p[3] = (char)((hlen >> 24) & 0xFF);
        p[4] = (char)(blen & 0xFF);
        p[5] = (char)((blen >> 8) & 0xFF);
        p[6] = (char)((blen >> 16) & 0xFF);
        p[7] = (char)((blen >> 24) & 0xFF);
    }
    return w_raw(w, (const char *)body->buf, body->len);
}

static int write_frame(W *w, PyObject *msg, PyObject *ttl, Py_buffer *body) {
    Py_ssize_t start;
    if (frame_begin(w, &start, body) < 0) return -1;
    if (enc_attr_tuple(w, msg, g_state.hdr_names, ttl) < 0)
        return -1;
    return frame_finish(w, start, body);
}

/* pack_frame(msg, ttl, body) -> bytes
 *
 * One C call for the whole wire frame: [u32 hlen][u32 blen][headers][body]
 * (the IncomingMessageBuffer length-prefixed layout).  Header payload
 * bytes are identical to pack_attrs(msg, hdr_names, ttl), so a peer that
 * only knows unpack_attrs decodes these frames unchanged — pack_frame
 * sheds the per-message Python-level struct.pack + two bytes-concats, not
 * the format. */
static PyObject *hw_pack_frame(PyObject *self, PyObject *args) {
    PyObject *msg, *ttl;
    Py_buffer body;
    if (!PyArg_ParseTuple(args, "OOy*", &msg, &ttl, &body))
        return NULL;
    if (!g_state.hdr_configured) {
        PyBuffer_Release(&body);
        PyErr_SetString(PyExc_RuntimeError,
                        "hotwire: headers not configured");
        return NULL;
    }
    W w;
    if (w_init(&w, 512) < 0) { PyBuffer_Release(&body); return NULL; }
    if (write_frame(&w, msg, ttl, &body) < 0) {
        w_free(&w);
        PyBuffer_Release(&body);
        return NULL;
    }
    PyObject *out = PyBytes_FromStringAndSize(w.buf, w.len);
    w_free(&w);
    PyBuffer_Release(&body);
    return out;
}

/* pack_batch(items) -> bytes
 *
 * Vectorized frame-batch encode: ``items`` is a sequence of
 * (msg, ttl, body_bytes) triples; the result is ONE contiguous buffer
 * holding every frame back to back — byte-identical to
 * b"".join(pack_frame(m, t, b) for m, t, b in items), so any peer that
 * decodes per-frame streams (or pack_attrs-era builds) reads batch sends
 * unchanged.  One C call per send batch replaces N pack_frame calls plus
 * the Python-level list + b"".join; any per-item failure fails the whole
 * call (the caller falls back to per-message encode, which scopes the
 * error to one message). */
static PyObject *hw_pack_batch(PyObject *self, PyObject *arg) {
    if (!g_state.hdr_configured) {
        PyErr_SetString(PyExc_RuntimeError,
                        "hotwire: headers not configured");
        return NULL;
    }
    PyObject *seq = PySequence_Fast(arg, "pack_batch: want a sequence of "
                                         "(msg, ttl, body) triples");
    if (!seq) return NULL;
    Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
    W w;
    if (w_init(&w, n > 0 ? 512 * n : 64) < 0) { Py_DECREF(seq); return NULL; }
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject *item = PySequence_Fast_GET_ITEM(seq, i);
        if (!PyTuple_Check(item) || PyTuple_GET_SIZE(item) != 3) {
            PyErr_SetString(PyExc_TypeError,
                            "pack_batch: items must be (msg, ttl, body)");
            goto fail;
        }
        Py_buffer body;
        if (PyObject_GetBuffer(PyTuple_GET_ITEM(item, 2), &body,
                               PyBUF_SIMPLE) < 0)
            goto fail;
        int rc = write_frame(&w, PyTuple_GET_ITEM(item, 0),
                             PyTuple_GET_ITEM(item, 1), &body);
        PyBuffer_Release(&body);
        if (rc < 0) goto fail;
    }
    {
        PyObject *out = PyBytes_FromStringAndSize(w.buf, w.len);
        w_free(&w);
        Py_DECREF(seq);
        return out;
    }
fail:
    w_free(&w);
    Py_DECREF(seq);
    return NULL;
}

/* Validate a varying-field index tuple against the configured header
 * spec: ints, strictly ascending, in [0, n_fields). Returns the count,
 * or -1 with an exception set. */
static Py_ssize_t check_var_indices(PyObject *vars) {
    Py_ssize_t n = PyTuple_GET_SIZE(g_state.hdr_names);
    Py_ssize_t k = PyTuple_GET_SIZE(vars);
    Py_ssize_t prev = -1;
    for (Py_ssize_t j = 0; j < k; j++) {
        PyObject *o = PyTuple_GET_ITEM(vars, j);
        if (!PyLong_Check(o)) {
            PyErr_SetString(PyExc_TypeError,
                            "var_indices: want a tuple of ints");
            return -1;
        }
        Py_ssize_t i = PyLong_AsSsize_t(o);
        if (i == -1 && PyErr_Occurred()) return -1;
        if (i <= prev || i >= n) {
            PyErr_SetString(PyExc_ValueError,
                            "var_indices: must be strictly ascending "
                            "and within the header field count");
            return -1;
        }
        prev = i;
    }
    return k;
}

/* make_header_template(msg, var_indices) -> tuple of bytes
 *
 * Pre-encode the INVARIANT portion of a message-header frame: the
 * returned tuple holds k+1 byte chunks — the header preamble
 * (magic/version/T_TUPLE/count) plus the encoded runs of invariant
 * fields between (and around) the k varying fields named by
 * ``var_indices``.  pack_batch_tmpl below memcpys the chunks and
 * encodes only the varying fields per message, producing bytes
 * identical to pack_frame whenever the invariant field VALUES match the
 * message the template was built from (the caller keys its template
 * cache on exactly those values). */
static PyObject *hw_make_header_template(PyObject *self, PyObject *args) {
    PyObject *msg, *vars;
    if (!PyArg_ParseTuple(args, "OO!", &msg, &PyTuple_Type, &vars))
        return NULL;
    if (!g_state.hdr_configured) {
        PyErr_SetString(PyExc_RuntimeError,
                        "hotwire: headers not configured");
        return NULL;
    }
    Py_ssize_t k = check_var_indices(vars);
    if (k < 0) return NULL;
    Py_ssize_t n = PyTuple_GET_SIZE(g_state.hdr_names);
    PyObject *chunks = PyTuple_New(k + 1);
    if (!chunks) return NULL;
    W w;
    if (w_init(&w, 256) < 0) { Py_DECREF(chunks); return NULL; }
    /* preamble: identical to enc_attr_tuple's opening bytes */
    if (w_byte(&w, HW_MAGIC) < 0 || w_byte(&w, HW_VERSION) < 0 ||
        w_byte(&w, T_TUPLE) < 0 ||
        w_varint(&w, (uint64_t)(n + 1)) < 0)
        goto fail;
    {
        Py_ssize_t vi = 0;
        for (Py_ssize_t i = 0; i < n; i++) {
            if (vi < k &&
                i == PyLong_AsSsize_t(PyTuple_GET_ITEM(vars, vi))) {
                /* varying field: close the current invariant chunk */
                PyObject *c = PyBytes_FromStringAndSize(w.buf, w.len);
                if (!c) goto fail;
                PyTuple_SET_ITEM(chunks, vi, c);
                w.len = 0;
                vi++;
                continue;
            }
            PyObject *v = PyObject_GetAttr(
                msg, PyTuple_GET_ITEM(g_state.hdr_names, i));
            if (!v) goto fail;
            int rc = enc_attr_value(&w, v);
            Py_DECREF(v);
            if (rc < 0) goto fail;
        }
        PyObject *tail = PyBytes_FromStringAndSize(w.buf, w.len);
        if (!tail) goto fail;
        PyTuple_SET_ITEM(chunks, k, tail);
    }
    w_free(&w);
    return chunks;
fail:
    w_free(&w);
    Py_DECREF(chunks);
    return NULL;
}

/* pack_batch_tmpl(chunks, var_indices, items) -> bytes
 *
 * Template-mode batch encode (the pre-encoded header-prefix cache):
 * each (msg, ttl, body) frame is written as
 *
 *   [len prefix][chunk0][enc var0][chunk1][enc var1]...[chunkK][ttl][body]
 *
 * — the invariant header runs are memcpy'd from the cached template and
 * only the varying fields (correlation id, per-message stamps, body
 * splice) are encoded per message.  Byte-identical to pack_batch /
 * N pack_frame calls when the template matches (property-tested).  Any
 * per-item failure fails the whole call; the caller falls back to the
 * per-message encode, which scopes the error to one frame. */
static PyObject *hw_pack_batch_tmpl(PyObject *self, PyObject *args) {
    PyObject *chunks, *vars, *arg;
    if (!PyArg_ParseTuple(args, "O!O!O", &PyTuple_Type, &chunks,
                          &PyTuple_Type, &vars, &arg))
        return NULL;
    if (!g_state.hdr_configured) {
        PyErr_SetString(PyExc_RuntimeError,
                        "hotwire: headers not configured");
        return NULL;
    }
    Py_ssize_t k = check_var_indices(vars);
    if (k < 0) return NULL;
    if (PyTuple_GET_SIZE(chunks) != k + 1) {
        PyErr_SetString(PyExc_ValueError,
                        "pack_batch_tmpl: want len(var_indices)+1 chunks");
        return NULL;
    }
    for (Py_ssize_t j = 0; j <= k; j++) {
        if (!PyBytes_Check(PyTuple_GET_ITEM(chunks, j))) {
            PyErr_SetString(PyExc_TypeError,
                            "pack_batch_tmpl: chunks must be bytes");
            return NULL;
        }
    }
    PyObject *seq = PySequence_Fast(arg, "pack_batch_tmpl: want a sequence "
                                         "of (msg, ttl, body) triples");
    if (!seq) return NULL;
    Py_ssize_t count = PySequence_Fast_GET_SIZE(seq);
    W w;
    if (w_init(&w, count > 0 ? 256 * count : 64) < 0) {
        Py_DECREF(seq);
        return NULL;
    }
    for (Py_ssize_t i = 0; i < count; i++) {
        PyObject *item = PySequence_Fast_GET_ITEM(seq, i);
        if (!PyTuple_Check(item) || PyTuple_GET_SIZE(item) != 3) {
            PyErr_SetString(PyExc_TypeError,
                            "pack_batch_tmpl: items must be "
                            "(msg, ttl, body)");
            goto fail;
        }
        PyObject *msg = PyTuple_GET_ITEM(item, 0);
        Py_buffer body;
        if (PyObject_GetBuffer(PyTuple_GET_ITEM(item, 2), &body,
                               PyBUF_SIMPLE) < 0)
            goto fail;
        Py_ssize_t start;
        int rc = frame_begin(&w, &start, &body);
        for (Py_ssize_t j = 0; rc == 0 && j < k; j++) {
            PyObject *c = PyTuple_GET_ITEM(chunks, j);
            rc = w_raw(&w, PyBytes_AS_STRING(c), PyBytes_GET_SIZE(c));
            if (rc == 0) {
                PyObject *name = PyTuple_GET_ITEM(
                    g_state.hdr_names,
                    PyLong_AsSsize_t(PyTuple_GET_ITEM(vars, j)));
                PyObject *v = PyObject_GetAttr(msg, name);
                if (!v) { rc = -1; break; }
                rc = enc_attr_value(&w, v);
                Py_DECREF(v);
            }
        }
        if (rc == 0) {
            PyObject *tail = PyTuple_GET_ITEM(chunks, k);
            rc = w_raw(&w, PyBytes_AS_STRING(tail),
                       PyBytes_GET_SIZE(tail));
        }
        if (rc == 0)
            rc = enc_value(&w, PyTuple_GET_ITEM(item, 1), 1);  /* ttl */
        if (rc == 0)
            rc = frame_finish(&w, start, &body);
        PyBuffer_Release(&body);
        if (rc < 0) goto fail;
    }
    {
        PyObject *out = PyBytes_FromStringAndSize(w.buf, w.len);
        w_free(&w);
        Py_DECREF(seq);
        return out;
    }
fail:
    w_free(&w);
    Py_DECREF(seq);
    return NULL;
}

/* unpack_attrs(data, obj, names, enum_spec) -> extra
 *
 * Inverse of pack_attrs: decodes the T_TUPLE, setattrs each of the first
 * len(names) values onto obj (restoring enum fields per enum_spec, a
 * tuple of (index, members_tuple) pairs), and returns the trailing extra
 * value. */
static PyObject *unpack_attrs_span(const uint8_t *buf, Py_ssize_t len,
                                   PyObject *obj, PyObject *names,
                                   PyObject *enum_spec) {
    R r = { buf, buf + len };
    Py_ssize_t n = PyTuple_GET_SIZE(names);
    PyObject *extra = NULL;
    PyObject **vals = NULL;

    if (len < 3 || r.p[0] != HW_MAGIC || r.p[1] != HW_VERSION ||
        r.p[2] != T_TUPLE) {
        PyErr_SetString(PyExc_ValueError, "hotwire: not a packed-attrs frame");
        goto done;
    }
    r.p += 3;
    uint64_t count;
    if (r_varint(&r, &count) < 0) goto done;
    if (count != (uint64_t)(n + 1)) {
        PyErr_Format(PyExc_ValueError,
                     "hotwire: field count %llu != expected %zd",
                     (unsigned long long)count, n + 1);
        goto done;
    }
    vals = PyMem_Calloc(n, sizeof(PyObject *));
    if (!vals) { PyErr_NoMemory(); goto done; }
    for (Py_ssize_t i = 0; i < n; i++) {
        vals[i] = dec_value(&r, 1);
        if (!vals[i]) goto done;
    }
    extra = dec_value(&r, 1);
    if (!extra) goto done;
    if (r.p != r.end) {
        Py_CLEAR(extra);
        PyErr_SetString(PyExc_ValueError, "hotwire: trailing garbage");
        goto done;
    }
    /* restore enum-typed fields */
    for (Py_ssize_t e = 0; e < PyTuple_GET_SIZE(enum_spec); e++) {
        PyObject *pair = PyTuple_GET_ITEM(enum_spec, e);
        if (!PyTuple_Check(pair) || PyTuple_GET_SIZE(pair) != 2) {
            Py_CLEAR(extra);
            PyErr_SetString(PyExc_TypeError, "enum_spec: want (index, members)");
            goto done;
        }
        Py_ssize_t idx = PyLong_AsSsize_t(PyTuple_GET_ITEM(pair, 0));
        PyObject *members = PyTuple_GET_ITEM(pair, 1);
        if (idx < 0 || idx >= n || !PyTuple_Check(members)) {
            Py_CLEAR(extra);
            PyErr_SetString(PyExc_ValueError, "enum_spec: bad entry");
            goto done;
        }
        PyObject *v = vals[idx];
        if (PyLong_CheckExact(v)) {
            Py_ssize_t ev = PyLong_AsSsize_t(v);
            if (ev < 0 || ev >= PyTuple_GET_SIZE(members) ||
                PyTuple_GET_ITEM(members, ev) == Py_None) {
                Py_CLEAR(extra);
                PyErr_Format(PyExc_ValueError,
                             "hotwire: bad enum value %zd at field %zd", ev, idx);
                goto done;
            }
            PyObject *m = PyTuple_GET_ITEM(members, ev);
            Py_INCREF(m);
            Py_SETREF(vals[idx], m);
        } else if (v != Py_None) {
            /* enum-typed header fields are None or int on the wire; any
             * other decoded object (str, tuple, ...) from a corrupt or
             * hostile peer must be rejected, matching the Python
             * fallback's strictness */
            Py_CLEAR(extra);
            PyErr_Format(PyExc_ValueError,
                         "hotwire: non-int enum value of type %.100s at "
                         "field %zd", Py_TYPE(v)->tp_name, idx);
            goto done;
        }
    }
    for (Py_ssize_t i = 0; i < n; i++) {
        if (PyObject_SetAttr(obj, PyTuple_GET_ITEM(names, i), vals[i]) < 0) {
            Py_CLEAR(extra);
            goto done;
        }
    }
done:
    if (vals) {
        for (Py_ssize_t i = 0; i < n; i++) Py_XDECREF(vals[i]);
        PyMem_Free(vals);
    }
    return extra;
}

static PyObject *unpack_attrs_impl(PyObject *data, PyObject *obj,
                                   PyObject *names, PyObject *enum_spec) {
    Py_buffer view;
    if (PyObject_GetBuffer(data, &view, PyBUF_SIMPLE) < 0) return NULL;
    PyObject *extra = unpack_attrs_span((const uint8_t *)view.buf, view.len,
                                        obj, names, enum_spec);
    PyBuffer_Release(&view);
    return extra;
}

static PyObject *hw_unpack_attrs(PyObject *self, PyObject *args) {
    PyObject *data, *obj, *names, *enum_spec;
    if (!PyArg_ParseTuple(args, "OOO!O!", &data, &obj, &PyTuple_Type, &names,
                          &PyTuple_Type, &enum_spec))
        return NULL;
    return unpack_attrs_impl(data, obj, names, enum_spec);
}

/* unpack_header(data, msg) -> ttl
 *
 * unpack_attrs against the cached header spec (configure_headers): the
 * per-frame decode passes only the buffer and the blank Message. */
static PyObject *hw_unpack_header(PyObject *self, PyObject *args) {
    PyObject *data, *obj;
    if (!PyArg_ParseTuple(args, "OO", &data, &obj))
        return NULL;
    if (!g_state.hdr_configured) {
        PyErr_SetString(PyExc_RuntimeError,
                        "hotwire: headers not configured");
        return NULL;
    }
    return unpack_attrs_impl(data, obj, g_state.hdr_names,
                             g_state.hdr_enum_spec);
}

/* unpack_batch(data, msg_cls) -> (consumed, entries)
 *
 * Vectorized receive-side decode: parse every COMPLETE length-prefixed
 * frame out of one contiguous receive buffer in a single C call.
 * ``consumed`` is how many bytes of ``data`` were fully parsed (the
 * caller discards that prefix and keeps the partial tail for the next
 * socket read).  Each entry is a triple:
 *
 *   (msg, ttl, body_bytes)      headers were hotwire frames and decoded
 *                               straight into a blank ``msg_cls``
 *                               instance via the cached header spec;
 *   (None, header_bytes, body_bytes)
 *                               headers were NOT native (pickle-peer
 *                               frames) or failed native decode — the
 *                               caller routes them through the ordinary
 *                               per-frame decode, which reproduces the
 *                               exact per-message error semantics.
 *
 * A header-decode failure is scoped to its frame (the length prefix
 * still delimits it); an oversized frame announcement raises — the
 * stream is hostile/misaligned and the connection must drop, exactly
 * like the per-frame path. */
/* Shared parse core of unpack_batch and sock_recv_batch: walk every
 * complete frame in [base, base+len), appending entries (see the
 * unpack_batch docstring for the entry shapes).  Returns the entry list
 * and sets *consumed_out; NULL with an exception set on a hostile
 * leading announcement or allocation failure. */
static PyObject *unpack_span_batch(const uint8_t *base, Py_ssize_t len,
                                   PyObject *msg_cls,
                                   Py_ssize_t *consumed_out) {
    Py_ssize_t pos = 0;
    PyObject *out = PyList_New(0);
    if (!out) return NULL;
    while (len - pos >= 8) {
        uint32_t hlen = (uint32_t)base[pos] | ((uint32_t)base[pos + 1] << 8) |
                        ((uint32_t)base[pos + 2] << 16) |
                        ((uint32_t)base[pos + 3] << 24);
        uint32_t blen = (uint32_t)base[pos + 4] |
                        ((uint32_t)base[pos + 5] << 8) |
                        ((uint32_t)base[pos + 6] << 16) |
                        ((uint32_t)base[pos + 7] << 24);
        if (hlen > HW_MAX_SEGMENT || blen > HW_MAX_SEGMENT) {
            /* hostile/misaligned announcement: frames already parsed out
             * of this buffer must still reach the caller (the per-frame
             * path delivered them before dropping the link), so stop
             * here when progress was made — the caller's NEXT call sees
             * the bad prefix at position 0 and raises then. */
            if (pos > 0)
                break;
            PyErr_Format(PyExc_ValueError,
                         "hotwire: oversized frame announced: %u+%u",
                         (unsigned)hlen, (unsigned)blen);
            goto fail;
        }
        Py_ssize_t total = 8 + (Py_ssize_t)hlen + (Py_ssize_t)blen;
        if (len - pos < total)
            break;  /* partial tail: next socket read completes it */
        const uint8_t *hp = base + pos + 8;
        PyObject *body = PyBytes_FromStringAndSize(
            (const char *)hp + hlen, (Py_ssize_t)blen);
        if (!body) goto fail;
        PyObject *entry = NULL;
        if (hlen >= 2 && hp[0] == HW_MAGIC && hp[1] == HW_VERSION) {
            PyObject *msg = blank_instance(msg_cls);
            if (msg) {
                PyObject *ttl = unpack_attrs_span(
                    hp, (Py_ssize_t)hlen, msg, g_state.hdr_names,
                    g_state.hdr_enum_spec);
                if (ttl) {
                    entry = PyTuple_Pack(3, msg, ttl, body);
                    Py_DECREF(ttl);
                    if (!entry) { Py_DECREF(msg); Py_DECREF(body); goto fail; }
                } else {
                    PyErr_Clear();  /* scoped to this frame: raw fallback */
                }
                Py_DECREF(msg);
            } else {
                PyErr_Clear();
            }
        }
        if (entry == NULL) {
            /* pickle-peer frame (or failed native decode): hand the raw
               segments back for the ordinary per-frame decode path */
            PyObject *hdr = PyBytes_FromStringAndSize(
                (const char *)hp, (Py_ssize_t)hlen);
            if (!hdr) { Py_DECREF(body); goto fail; }
            entry = PyTuple_Pack(3, Py_None, hdr, body);
            Py_DECREF(hdr);
            if (!entry) { Py_DECREF(body); goto fail; }
        }
        Py_DECREF(body);
        int rc = PyList_Append(out, entry);
        Py_DECREF(entry);
        if (rc < 0) goto fail;
        pos += total;
    }
    *consumed_out = pos;
    return out;
fail:
    Py_DECREF(out);
    return NULL;
}

static PyObject *hw_unpack_batch(PyObject *self, PyObject *args) {
    PyObject *data, *msg_cls;
    if (!PyArg_ParseTuple(args, "OO", &data, &msg_cls))
        return NULL;
    if (!g_state.hdr_configured) {
        PyErr_SetString(PyExc_RuntimeError,
                        "hotwire: headers not configured");
        return NULL;
    }
    if (!PyType_Check(msg_cls)) {
        PyErr_SetString(PyExc_TypeError, "unpack_batch: msg_cls not a type");
        return NULL;
    }
    Py_buffer view;
    if (PyObject_GetBuffer(data, &view, PyBUF_SIMPLE) < 0) return NULL;
    Py_ssize_t pos = 0;
    PyObject *out = unpack_span_batch((const uint8_t *)view.buf, view.len,
                                      msg_cls, &pos);
    PyBuffer_Release(&view);
    if (!out) return NULL;
    {
        PyObject *consumed = PyLong_FromSsize_t(pos);
        if (!consumed) { Py_DECREF(out); return NULL; }
        PyObject *res = PyTuple_Pack(2, consumed, out);
        Py_DECREF(consumed);
        Py_DECREF(out);
        return res;
    }
}

#ifndef MS_WINDOWS
/* sock_recv_batch(fd, tail, msg_cls, bufsize=65536)
 *     -> (entries, tail2, eof, nrecv)  |  None when not readable
 *
 * The vectored receive pump: ONE C call per socket-ready event replaces
 * the Python recv -> buffer-append -> decode_frames chain.  The previous
 * read's partial-frame ``tail`` and a fresh ``recv`` (GIL released
 * around the syscall) are parsed in a single pass through the same frame
 * walk as ``unpack_batch``; ``tail2`` is the new partial remainder and
 * ``eof`` is True on an orderly shutdown (recv() == 0).  EAGAIN returns
 * None — the caller waits for readability and calls again.  A hostile
 * leading announcement raises ValueError exactly like ``unpack_batch``
 * (frames parsed ahead of one were already returned by the PREVIOUS
 * call; the caller also screens ``tail2`` with ``leads_hostile_frame``
 * so a peer that never sends another byte still drops promptly). */
static PyObject *hw_sock_recv_batch(PyObject *self, PyObject *args) {
    int fd;
    Py_buffer tail;
    PyObject *msg_cls;
    Py_ssize_t bufsize = 1 << 16;
    if (!PyArg_ParseTuple(args, "iy*O|n", &fd, &tail, &msg_cls, &bufsize))
        return NULL;
    if (!g_state.hdr_configured || !PyType_Check(msg_cls) || bufsize <= 0) {
        PyBuffer_Release(&tail);
        PyErr_SetString(PyExc_ValueError,
                        "sock_recv_batch: headers not configured / bad args");
        return NULL;
    }
    char *buf = PyMem_Malloc(tail.len + bufsize);
    if (!buf) { PyBuffer_Release(&tail); return PyErr_NoMemory(); }
    if (tail.len)
        memcpy(buf, tail.buf, tail.len);
    Py_ssize_t tlen = tail.len;
    PyBuffer_Release(&tail);
    ssize_t n;
    Py_BEGIN_ALLOW_THREADS
    do {
        n = recv(fd, buf + tlen, (size_t)bufsize, 0);
    } while (n < 0 && errno == EINTR);
    Py_END_ALLOW_THREADS
    if (n < 0) {
        if (errno == EAGAIN || errno == EWOULDBLOCK) {
            PyMem_Free(buf);
            Py_RETURN_NONE;
        }
        PyErr_SetFromErrno(PyExc_OSError);
        PyMem_Free(buf);
        return NULL;
    }
    {
        Py_ssize_t total = tlen + (Py_ssize_t)n;
        Py_ssize_t consumed = 0;
        PyObject *entries = unpack_span_batch((const uint8_t *)buf, total,
                                              msg_cls, &consumed);
        if (!entries) { PyMem_Free(buf); return NULL; }
        PyObject *tail2 = PyBytes_FromStringAndSize(buf + consumed,
                                                    total - consumed);
        PyMem_Free(buf);
        if (!tail2) { Py_DECREF(entries); return NULL; }
        PyObject *nrecv = PyLong_FromSsize_t((Py_ssize_t)n);
        if (!nrecv) { Py_DECREF(entries); Py_DECREF(tail2); return NULL; }
        PyObject *res = PyTuple_Pack(4, entries, tail2,
                                     n == 0 ? Py_True : Py_False, nrecv);
        Py_DECREF(entries);
        Py_DECREF(tail2);
        Py_DECREF(nrecv);
        return res;
    }
}

/* sock_writev(fd, chunks) -> bytes written
 *
 * The vectored egress half: one ``writev`` syscall (GIL released) sends
 * a whole encode_message_batch chunk list without the Python-level
 * b"".join copy.  May write a PARTIAL prefix (kernel buffer full) — the
 * caller computes the remainder and falls back to its buffered path.
 * Raises BlockingIOError when nothing could be written (EAGAIN), OSError
 * on a dead socket.  At most IOV_MAX chunks ride one call; the caller
 * loops for longer lists. */
#ifndef IOV_MAX
#define IOV_MAX 1024
#endif
static PyObject *hw_sock_writev(PyObject *self, PyObject *args) {
    int fd;
    PyObject *arg;
    if (!PyArg_ParseTuple(args, "iO", &fd, &arg))
        return NULL;
    PyObject *seq = PySequence_Fast(arg, "sock_writev: want a sequence of "
                                         "bytes chunks");
    if (!seq) return NULL;
    Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
    if (n > IOV_MAX)
        n = IOV_MAX;
    struct iovec *iov = PyMem_Malloc((n ? n : 1) * sizeof(struct iovec));
    Py_buffer *views = PyMem_Calloc(n ? n : 1, sizeof(Py_buffer));
    if (!iov || !views) {
        PyMem_Free(iov); PyMem_Free(views); Py_DECREF(seq);
        return PyErr_NoMemory();
    }
    Py_ssize_t got = 0;
    ssize_t sent = 0;
    for (; got < n; got++) {
        if (PyObject_GetBuffer(PySequence_Fast_GET_ITEM(seq, got),
                               &views[got], PyBUF_SIMPLE) < 0)
            goto fail;
        iov[got].iov_base = views[got].buf;
        iov[got].iov_len = (size_t)views[got].len;
    }
    Py_BEGIN_ALLOW_THREADS
    do {
        sent = writev(fd, iov, (int)n);
    } while (sent < 0 && errno == EINTR);
    Py_END_ALLOW_THREADS
    if (sent < 0) {
        PyErr_SetFromErrno(PyExc_OSError);  /* EAGAIN -> BlockingIOError */
        goto fail;
    }
    for (Py_ssize_t i = 0; i < got; i++)
        PyBuffer_Release(&views[i]);
    PyMem_Free(iov); PyMem_Free(views); Py_DECREF(seq);
    return PyLong_FromSsize_t((Py_ssize_t)sent);
fail:
    for (Py_ssize_t i = 0; i < got; i++)
        PyBuffer_Release(&views[i]);
    PyMem_Free(iov); PyMem_Free(views); Py_DECREF(seq);
    return NULL;
}

/* bind_reuseport(host, port) -> fd
 *
 * One listening socket in an SO_REUSEPORT accept group (the
 * multi-process silo's advertised endpoint): the option is set BEFORE
 * bind — the kernel's admission rule for joining a group — so every
 * worker process that calls this with the same (host, port) gets its
 * own kernel accept queue and the kernel hash-balances incoming
 * connections across them.  Raises OSError where the platform has no
 * SO_REUSEPORT rather than silently binding without it (a group member
 * that never joined would steal nothing, but one that joined and never
 * accepts black-holes its share — better to fail loudly). */
static PyObject *hw_bind_reuseport(PyObject *self, PyObject *args) {
    const char *host;
    int port;
    if (!PyArg_ParseTuple(args, "si", &host, &port))
        return NULL;
#ifndef SO_REUSEPORT
    PyErr_SetString(PyExc_OSError, "SO_REUSEPORT not supported here");
    return NULL;
#else
    int fd = socket(AF_INET, SOCK_STREAM, 0);
    if (fd < 0)
        return PyErr_SetFromErrno(PyExc_OSError);
    int one = 1;
    struct sockaddr_in sa;
    memset(&sa, 0, sizeof(sa));
    sa.sin_family = AF_INET;
    sa.sin_port = htons((uint16_t)port);
    if (inet_pton(AF_INET, host, &sa.sin_addr) != 1) {
        close(fd);
        PyErr_Format(PyExc_ValueError, "bind_reuseport: bad host %s", host);
        return NULL;
    }
    if (setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one)) < 0 ||
        setsockopt(fd, SOL_SOCKET, SO_REUSEPORT, &one, sizeof(one)) < 0 ||
        bind(fd, (struct sockaddr *)&sa, sizeof(sa)) < 0 ||
        listen(fd, 128) < 0) {
        PyErr_SetFromErrno(PyExc_OSError);
        close(fd);
        return NULL;
    }
    return PyLong_FromLong(fd);
#endif
}

/* SPSC shm ring primitives — the cross-process staging ring's hot half.
 *
 * Layout (shared with the pure-Python twin in runtime/multiproc.py —
 * a native producer and a Python consumer interoperate):
 *   [0:8]   write_cum     producer-only writer
 *   [8:16]  pushed_msgs   producer-only writer
 *   [64:72] read_cum      consumer-only writer (own cache line)
 *   [72:80] drained_msgs  consumer-only writer
 *   [128:]  data (capacity bytes, 8-aligned); records are
 *           u32 len | u32 n_msgs | payload, padded to 8; u32
 *           0xFFFFFFFF marks an end-of-region wrap skip.
 * Each counter has exactly one writer, so plain stores suffice for the
 * owner side; the cross-side loads/stores pair acquire/release so the
 * payload bytes are visible before the counter that publishes them. */
#define SHM_HDR 128
#define SHM_WRAP 0xFFFFFFFFu

/* shm_push(buf, capacity, payload, n_msgs) -> bool (False = ring full) */
static PyObject *hw_shm_push(PyObject *self, PyObject *args) {
    Py_buffer buf, payload;
    Py_ssize_t cap;
    unsigned long long n_msgs;
    if (!PyArg_ParseTuple(args, "w*ny*K", &buf, &cap, &payload, &n_msgs))
        return NULL;
    if (cap <= 64 || (cap & 7) || buf.len < SHM_HDR + cap) {
        PyBuffer_Release(&buf); PyBuffer_Release(&payload);
        PyErr_SetString(PyExc_ValueError, "shm_push: bad ring buffer");
        return NULL;
    }
    uint8_t *base = (uint8_t *)buf.buf;
    uint8_t *data = base + SHM_HDR;
    uint64_t ln = (uint64_t)payload.len;
    uint64_t rec = 8 + ((ln + 7) & ~7ULL);
    if (rec > (uint64_t)cap - 8) {
        PyBuffer_Release(&buf); PyBuffer_Release(&payload);
        PyErr_Format(PyExc_ValueError,
                     "shm_push: record of %llu bytes exceeds capacity %zd",
                     (unsigned long long)ln, cap);
        return NULL;
    }
    uint64_t wc = __atomic_load_n((uint64_t *)(base + 0), __ATOMIC_RELAXED);
    uint64_t rc = __atomic_load_n((uint64_t *)(base + 64), __ATOMIC_ACQUIRE);
    uint64_t pos = wc % (uint64_t)cap;
    uint64_t contig = (uint64_t)cap - pos;
    uint64_t need = rec + (contig < rec ? contig : 0);
    if ((uint64_t)cap - (wc - rc) < need) {
        PyBuffer_Release(&buf); PyBuffer_Release(&payload);
        Py_RETURN_FALSE;
    }
    if (contig < rec) {
        uint32_t w = SHM_WRAP;
        memcpy(data + pos, &w, 4);
        wc += contig;
        pos = 0;
    }
    uint32_t l32 = (uint32_t)ln, m32 = (uint32_t)n_msgs;
    memcpy(data + pos, &l32, 4);
    memcpy(data + pos + 4, &m32, 4);
    if (ln)
        memcpy(data + pos + 8, payload.buf, ln);
    uint64_t pushed = *(uint64_t *)(base + 8);
    __atomic_store_n((uint64_t *)(base + 0), wc + rec, __ATOMIC_RELEASE);
    __atomic_store_n((uint64_t *)(base + 8), pushed + n_msgs,
                     __ATOMIC_RELEASE);
    PyBuffer_Release(&buf); PyBuffer_Release(&payload);
    Py_RETURN_TRUE;
}

/* shm_pop(buf, capacity) -> (payload, n_msgs) | None */
static PyObject *hw_shm_pop(PyObject *self, PyObject *args) {
    Py_buffer buf;
    Py_ssize_t cap;
    if (!PyArg_ParseTuple(args, "w*n", &buf, &cap))
        return NULL;
    if (cap <= 64 || (cap & 7) || buf.len < SHM_HDR + cap) {
        PyBuffer_Release(&buf);
        PyErr_SetString(PyExc_ValueError, "shm_pop: bad ring buffer");
        return NULL;
    }
    uint8_t *base = (uint8_t *)buf.buf;
    uint8_t *data = base + SHM_HDR;
    for (;;) {
        uint64_t rc = __atomic_load_n((uint64_t *)(base + 64),
                                      __ATOMIC_RELAXED);
        uint64_t wc = __atomic_load_n((uint64_t *)(base + 0),
                                      __ATOMIC_ACQUIRE);
        if (wc == rc) {
            PyBuffer_Release(&buf);
            Py_RETURN_NONE;
        }
        uint64_t pos = rc % (uint64_t)cap;
        uint32_t l32, m32;
        memcpy(&l32, data + pos, 4);
        if (l32 == SHM_WRAP) {
            __atomic_store_n((uint64_t *)(base + 64),
                             rc + ((uint64_t)cap - pos), __ATOMIC_RELEASE);
            continue;
        }
        memcpy(&m32, data + pos + 4, 4);
        uint64_t rec = 8 + (((uint64_t)l32 + 7) & ~7ULL);
        if (rec > (uint64_t)cap - pos) {
            PyBuffer_Release(&buf);
            PyErr_SetString(PyExc_ValueError, "shm_pop: corrupt record");
            return NULL;
        }
        PyObject *payload = PyBytes_FromStringAndSize(
            (const char *)(data + pos + 8), (Py_ssize_t)l32);
        if (!payload) { PyBuffer_Release(&buf); return NULL; }
        uint64_t drained = *(uint64_t *)(base + 72);
        __atomic_store_n((uint64_t *)(base + 64), rc + rec,
                         __ATOMIC_RELEASE);
        __atomic_store_n((uint64_t *)(base + 72), drained + m32,
                         __ATOMIC_RELEASE);
        PyObject *res = Py_BuildValue("(Nk)", payload,
                                      (unsigned long)m32);
        PyBuffer_Release(&buf);
        return res;
    }
}
#endif /* !MS_WINDOWS */

static PyMethodDef hw_methods[] = {
    {"dumps", hw_dumps, METH_O,
     "Encode a value to hotwire bytes (magic-prefixed)."},
    {"loads", hw_loads, METH_O,
     "Decode hotwire bytes back to a value."},
    {"pack_attrs", hw_pack_attrs, METH_VARARGS,
     "pack_attrs(obj, names, extra) -> bytes: encode getattr'd fields."},
    {"unpack_attrs", hw_unpack_attrs, METH_VARARGS,
     "unpack_attrs(data, obj, names, enum_spec) -> extra: decode + setattr."},
    {"configure_headers", hw_configure_headers, METH_VARARGS,
     "configure_headers(names, enum_spec): cache the Message header spec."},
    {"pack_frame", hw_pack_frame, METH_VARARGS,
     "pack_frame(msg, ttl, body) -> bytes: full length-prefixed frame."},
    {"pack_batch", hw_pack_batch, METH_O,
     "pack_batch(items) -> bytes: encode (msg, ttl, body) triples into "
     "one contiguous frame-batch buffer."},
    {"make_header_template", hw_make_header_template, METH_VARARGS,
     "make_header_template(msg, var_indices) -> chunk tuple: pre-encode "
     "the invariant header runs around the varying fields."},
    {"pack_batch_tmpl", hw_pack_batch_tmpl, METH_VARARGS,
     "pack_batch_tmpl(chunks, var_indices, items) -> bytes: template-"
     "mode frame-batch encode (memcpy invariant runs, encode varying "
     "fields per message)."},
    {"unpack_header", hw_unpack_header, METH_VARARGS,
     "unpack_header(data, msg) -> ttl: decode + setattr via cached spec."},
    {"unpack_batch", hw_unpack_batch, METH_VARARGS,
     "unpack_batch(data, msg_cls) -> (consumed, entries): decode every "
     "complete frame out of one receive buffer."},
#ifndef MS_WINDOWS
    {"sock_recv_batch", hw_sock_recv_batch, METH_VARARGS,
     "sock_recv_batch(fd, tail, msg_cls, bufsize=65536) -> "
     "(entries, tail2, eof, nrecv) | None: one recv + frame-batch "
     "decode per socket-ready event."},
    {"sock_writev", hw_sock_writev, METH_VARARGS,
     "sock_writev(fd, chunks) -> bytes written: vectored send of an "
     "encoded chunk list (partial writes possible)."},
    {"bind_reuseport", hw_bind_reuseport, METH_VARARGS,
     "bind_reuseport(host, port) -> fd: listening socket in an "
     "SO_REUSEPORT accept group (option set before bind)."},
    {"shm_push", hw_shm_push, METH_VARARGS,
     "shm_push(buf, capacity, payload, n_msgs) -> bool: append one "
     "record to a cross-process SPSC shm ring (False = full)."},
    {"shm_pop", hw_shm_pop, METH_VARARGS,
     "shm_pop(buf, capacity) -> (payload, n_msgs) | None: pop one "
     "record from a cross-process SPSC shm ring."},
#endif
    {"configure", hw_configure, METH_VARARGS,
     "configure(GrainId, cat_members, SiloAddress, ActivationId, "
     "ActivationAddress, pickle_dumps, restricted_loads)"},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef hw_module = {
    PyModuleDef_HEAD_INIT, "_hotwire",
    "Native wire-tier codec for orleans_tpu_torch.", -1, hw_methods,
};

PyMODINIT_FUNC PyInit__hotwire(void) {
    memset(&g_state, 0, sizeof(g_state));
    empty_args = PyTuple_New(0);
    if (!empty_args) return NULL;
    return PyModule_Create(&hw_module);
}
