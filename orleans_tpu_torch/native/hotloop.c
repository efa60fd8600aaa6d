/* hotloop — native per-callback runner for the host-loop occupancy
 * profiler (observability.profiling.LoopProfiler); the port's copy of
 * orleans_tpu's hotloop.c.
 *
 * The profiler interposes on the event loop's call_soon/call_at and
 * times EVERY callback the loop runs.  In pure Python that prologue/
 * epilogue costs ~1.3us per callback (a Python frame, two
 * time.perf_counter calls, a contextvar read, two dict upserts, ~10
 * slot accesses) — measurable against the ~2.5us a trivial loop
 * callback costs at all.  This module is the same accounting as
 * LoopProfiler._run_cb/set_category compiled to C (~0.2-0.3us): the
 * loop schedules ONE Runner instance with the real callback as its
 * first argument, the Runner vectorcalls the callback between two
 * clock reads, and attributes the elapsed time into the shared
 * window-category dict.
 *
 * Division of labour: the Runner owns the HOT state (mark / last_end /
 * win_start / top_min / depth / closed scalars, the current category +
 * label, the open window's category->seconds dict) and exposes every
 * field as a writable member, so the Python LoopProfiler's slow paths
 * (window finalize, flight-recorder trigger, flush, enter/exit token
 * discipline) keep operating on the very same state through delegating
 * properties.  The two rare epilogue branches — top-K admission and
 * window finalize — call back into the Python profiler.
 *
 * Clock: CLOCK_MONOTONIC, the same base CPython uses for
 * time.perf_counter on Linux, so C-side stamps and Python-side stamps
 * interchange freely.
 *
 * Error discipline: accounting failures (OOM on a dict upsert) are
 * reported via PyErr_WriteUnraisable and never mask or corrupt the
 * wrapped callback's own result/exception; the callback's exception is
 * held across the epilogue's Python calls and re-raised unchanged.
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <structmember.h>
#include <time.h>

static inline double mono_clock(void) {
    struct timespec ts;
    clock_gettime(CLOCK_MONOTONIC, &ts);
    return (double)ts.tv_sec + (double)ts.tv_nsec * 1e-9;
}

/* interned keys / method names, set at module init */
static PyObject *s_idle, *s_other, *s_record_top, *s_finalize_window;

typedef struct {
    PyObject_HEAD
    vectorcallfunc vcall;
    double mark;        /* last attribution boundary */
    double last_end;    /* end of the previous callback (idle from) */
    double win_start;   /* current window start */
    double top_min;     /* top-K admission bar */
    double window;      /* seconds per occupancy slice */
    int depth;          /* >0 while inside a wrapped callback */
    int closed;         /* uninstalled: pass callbacks straight through */
    PyObject *cur;      /* category accruing since mark (str) */
    PyObject *cb_label; /* label for the top-K record, or None */
    PyObject *win_cats; /* dict: category -> seconds (open window) */
    PyObject *cat_var;  /* the LOOP_CATEGORY contextvar */
    PyObject *profiler; /* the owning LoopProfiler (slow paths) */
} Runner;

/* win_cats[key] += v (missing -> v).  Failures never propagate: the
 * callback's own outcome must not be masked by accounting. */
static void dict_add(PyObject *d, PyObject *key, double v) {
    if (d == NULL || key == NULL)
        return;
    PyObject *old = PyDict_GetItemWithError(d, key); /* borrowed */
    if (old == NULL && PyErr_Occurred())
        goto fail;
    if (old != NULL) {
        double prev = PyFloat_AsDouble(old);
        if (prev == -1.0 && PyErr_Occurred())
            goto fail;
        v += prev;
    }
    PyObject *f = PyFloat_FromDouble(v);
    if (f == NULL)
        goto fail;
    int rc = PyDict_SetItem(d, key, f);
    Py_DECREF(f);
    if (rc < 0)
        goto fail;
    return;
fail:
    PyErr_WriteUnraisable(d);
}

/* call profiler.<name>(...) with any pending exception preserved
 * (a2/a3 may be NULL — ObjArgs terminates at the first NULL) */
static void call_slow_path(Runner *r, PyObject *name, PyObject *a1,
                           PyObject *a2, PyObject *a3) {
    PyObject *exc_type, *exc_val, *exc_tb;
    PyErr_Fetch(&exc_type, &exc_val, &exc_tb);
    PyObject *res = PyObject_CallMethodObjArgs(r->profiler, name, a1, a2,
                                               a3, NULL);
    if (res == NULL)
        PyErr_WriteUnraisable(r->profiler);
    else
        Py_DECREF(res);
    PyErr_Restore(exc_type, exc_val, exc_tb);
}

static PyObject *runner_vectorcall(PyObject *self, PyObject *const *args,
                                   size_t nargsf, PyObject *kwnames) {
    Runner *r = (Runner *)self;
    Py_ssize_t nargs = PyVectorcall_NARGS(nargsf);
    if (nargs < 1 || (kwnames != NULL && PyTuple_GET_SIZE(kwnames) > 0)) {
        PyErr_SetString(PyExc_TypeError,
                        "Runner(callback, *args) takes a positional "
                        "callback and its positional arguments");
        return NULL;
    }
    PyObject *cb = args[0];
    if (r->closed)
        return PyObject_Vectorcall(cb, args + 1, nargs - 1, NULL);
    if (r->depth) {
        /* nested invocation (a wrapped fn called synchronously from
         * inside another): inner boundaries are a no-op */
        r->depth++;
        PyObject *res = PyObject_Vectorcall(cb, args + 1, nargs - 1, NULL);
        r->depth--;
        return res;
    }
    double now = mono_clock();
    double gap = now - r->last_end;
    if (gap > 0.0)
        /* the loop was in select() between callbacks: idle */
        dict_add(r->win_cats, s_idle, gap);
    r->depth = 1;
    r->mark = now;
    PyObject *cur;
    if (PyContextVar_Get(r->cat_var, s_other, &cur) < 0) {
        PyErr_WriteUnraisable(self);
        cur = Py_NewRef(s_other);
    }
    Py_XSETREF(r->cur, cur);                 /* owned */
    Py_XSETREF(r->cb_label, Py_NewRef(Py_None));

    PyObject *res = PyObject_Vectorcall(cb, args + 1, nargs - 1, NULL);

    /* hold the callback's exception across the whole epilogue: dict
     * lookups misread a pending exception as their own failure (and
     * would swallow it via PyErr_WriteUnraisable) */
    PyObject *exc_type = NULL, *exc_val = NULL, *exc_tb = NULL;
    if (res == NULL)
        PyErr_Fetch(&exc_type, &exc_val, &exc_tb);

    double end = mono_clock();
    r->depth = 0;
    double d = end - r->mark;
    if (d > 0.0)
        dict_add(r->win_cats, r->cur, d);
    r->last_end = end;
    if (end - now > r->top_min) {
        /* top-K slow-callback record (rare: the bar rises to the K-th
         * slowest as the window fills).  The third argument is the
         * callback's start offset WITHIN the open window, so the
         * Perfetto flame row places the record exactly instead of
         * laying durations end-to-end from the window start. */
        PyObject *dur = PyFloat_FromDouble(end - now);
        PyObject *off = PyFloat_FromDouble(now - r->win_start);
        if (dur != NULL && off != NULL)
            call_slow_path(r, s_record_top, cb, dur, off);
        Py_XDECREF(dur);
        Py_XDECREF(off);
    }
    if (end - r->win_start >= r->window) {
        PyObject *endf = PyFloat_FromDouble(end);
        if (endf != NULL) {
            call_slow_path(r, s_finalize_window, endf, NULL, NULL);
            Py_DECREF(endf);
        }
    }
    if (res == NULL)
        PyErr_Restore(exc_type, exc_val, exc_tb);
    return res; /* NULL propagates the callback's exception unchanged */
}

/* set_category(category, label=None): accrue to the current category up
 * to now, then switch — the engine segments one tick callback into
 * staging/transfer/sync slices with this, several times per tick. */
static PyObject *runner_set_category(PyObject *self, PyObject *const *args,
                                     Py_ssize_t nargs) {
    Runner *r = (Runner *)self;
    if (nargs < 1 || nargs > 2) {
        PyErr_SetString(PyExc_TypeError,
                        "set_category(category, label=None)");
        return NULL;
    }
    if (!r->depth || r->closed)
        Py_RETURN_NONE; /* outside a wrapped callback: no loop time */
    double now = mono_clock();
    double d = now - r->mark;
    if (d > 0.0)
        dict_add(r->win_cats, r->cur, d);
    r->mark = now;
    Py_XSETREF(r->cur, Py_NewRef(args[0]));
    if (nargs == 2 && args[1] != Py_None)
        Py_XSETREF(r->cb_label, Py_NewRef(args[1]));
    Py_RETURN_NONE;
}

static int runner_init(PyObject *self, PyObject *args, PyObject *kw) {
    Runner *r = (Runner *)self;
    PyObject *cat_var, *profiler;
    if (!PyArg_ParseTuple(args, "OO", &cat_var, &profiler))
        return -1;
    r->vcall = runner_vectorcall;
    double now = mono_clock();
    r->mark = r->last_end = r->win_start = now;
    r->top_min = 0.0;
    r->window = 1.0;
    r->depth = 0;
    r->closed = 0;
    Py_XSETREF(r->cur, Py_NewRef(s_other));
    Py_XSETREF(r->cb_label, Py_NewRef(Py_None));
    PyObject *d = PyDict_New();
    if (d == NULL)
        return -1;
    Py_XSETREF(r->win_cats, d);
    Py_XSETREF(r->cat_var, Py_NewRef(cat_var));
    Py_XSETREF(r->profiler, Py_NewRef(profiler));
    return 0;
}

static int runner_traverse(PyObject *self, visitproc visit, void *arg) {
    Runner *r = (Runner *)self;
    Py_VISIT(r->cur);
    Py_VISIT(r->cb_label);
    Py_VISIT(r->win_cats);
    Py_VISIT(r->cat_var);
    Py_VISIT(r->profiler);
    return 0;
}

static int runner_clear(PyObject *self) {
    Runner *r = (Runner *)self;
    Py_CLEAR(r->cur);
    Py_CLEAR(r->cb_label);
    Py_CLEAR(r->win_cats);
    Py_CLEAR(r->cat_var);
    Py_CLEAR(r->profiler);
    return 0;
}

static void runner_dealloc(PyObject *self) {
    PyObject_GC_UnTrack(self);
    runner_clear(self);
    Py_TYPE(self)->tp_free(self);
}

static PyMemberDef runner_members[] = {
    {"mark", T_DOUBLE, offsetof(Runner, mark), 0,
     "last attribution boundary (perf_counter base)"},
    {"last_end", T_DOUBLE, offsetof(Runner, last_end), 0,
     "end of the previous callback"},
    {"win_start", T_DOUBLE, offsetof(Runner, win_start), 0,
     "current window start"},
    {"top_min", T_DOUBLE, offsetof(Runner, top_min), 0,
     "top-K admission bar"},
    {"window", T_DOUBLE, offsetof(Runner, window), 0,
     "seconds per occupancy slice"},
    {"depth", T_INT, offsetof(Runner, depth), 0,
     ">0 while inside a wrapped callback"},
    {"closed", T_INT, offsetof(Runner, closed), 0,
     "uninstalled: callbacks pass straight through"},
    {"cur", T_OBJECT, offsetof(Runner, cur), 0,
     "category accruing since mark"},
    {"cb_label", T_OBJECT, offsetof(Runner, cb_label), 0,
     "top-K label for the current callback, or None"},
    {"win_cats", T_OBJECT, offsetof(Runner, win_cats), 0,
     "open window's category -> seconds dict"},
    {"cat_var", T_OBJECT, offsetof(Runner, cat_var), READONLY,
     "the LOOP_CATEGORY contextvar"},
    {NULL},
};

static PyMethodDef runner_methods[] = {
    {"set_category", (PyCFunction)(void (*)(void))runner_set_category,
     METH_FASTCALL,
     "set_category(category, label=None): accrue and switch the "
     "attribution category within the current callback."},
    {NULL, NULL, 0, NULL},
};

static PyTypeObject RunnerType = {
    PyVarObject_HEAD_INIT(NULL, 0)
    .tp_name = "_hotloop.Runner",
    .tp_basicsize = sizeof(Runner),
    .tp_flags = Py_TPFLAGS_DEFAULT | Py_TPFLAGS_HAVE_GC |
                Py_TPFLAGS_HAVE_VECTORCALL,
    .tp_doc = "Native per-callback occupancy runner (see module doc).",
    .tp_new = PyType_GenericNew,
    .tp_init = runner_init,
    .tp_dealloc = runner_dealloc,
    .tp_traverse = runner_traverse,
    .tp_clear = runner_clear,
    .tp_call = PyVectorcall_Call,
    .tp_vectorcall_offset = offsetof(Runner, vcall),
    .tp_members = runner_members,
    .tp_methods = runner_methods,
};

static struct PyModuleDef hl_module = {
    PyModuleDef_HEAD_INIT, "_hotloop",
    "Native host-loop occupancy runner for orleans_tpu_torch.", -1, NULL,
};

PyMODINIT_FUNC PyInit__hotloop(void) {
    s_idle = PyUnicode_InternFromString("idle");
    s_other = PyUnicode_InternFromString("other");
    s_record_top = PyUnicode_InternFromString("_record_top");
    s_finalize_window = PyUnicode_InternFromString("_finalize_window");
    if (!s_idle || !s_other || !s_record_top || !s_finalize_window)
        return NULL;
    if (PyType_Ready(&RunnerType) < 0)
        return NULL;
    PyObject *m = PyModule_Create(&hl_module);
    if (m == NULL)
        return NULL;
    Py_INCREF(&RunnerType);
    if (PyModule_AddObject(m, "Runner", (PyObject *)&RunnerType) < 0) {
        Py_DECREF(&RunnerType);
        Py_DECREF(m);
        return NULL;
    }
    return m;
}
