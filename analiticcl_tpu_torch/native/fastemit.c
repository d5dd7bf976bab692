/* fastemit: C-level bulk construction of per-query VariantResult lists.
 *
 * The port's copy of analiticcl_tpu/native/fastemit.c, built as the module
 * _fastemit_torch so that it loads beside the JAX package's _fastemit.
 *
 * Mirrors the pipeline tail_emit bulk path (ops/pipeline.py): survivors
 * arrive seg-major in final rank order as flat columns (vocab_id int64,
 * dist_score f64, freq_score f64) with per-segment bounds; the reference
 * returns Vec<VariantResult> per query (lib.rs:1143-1308, types.rs:318-332),
 * so query mode must materialize one list of result records per input.
 * Python-side construction (tuple.__new__ over zipped .tolist() columns)
 * costs ~30% of streamed query wall on the one-core host; this does the
 * same work in a single C pass.
 *
 * build_result_lists(cls, vid_i64, ds_f64, fq_f64, bounds_i64, nrows)
 *   -> list (len nrows) of lists of `cls` instances, where `cls` is a
 *      variable-size tuple subclass with layout (vid, ds, fq, via=None).
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <stdint.h>

static PyObject *
build_result_lists(PyObject *self, PyObject *args)
{
    PyObject *cls_obj;
    Py_buffer vb, db, fb, bb;
    Py_ssize_t nrows;
    if (!PyArg_ParseTuple(args, "Oy*y*y*y*n",
                          &cls_obj, &vb, &db, &fb, &bb, &nrows))
        return NULL;

    PyObject *outer = NULL;
    if (!PyType_Check(cls_obj)) {
        PyErr_SetString(PyExc_TypeError, "cls must be a type");
        goto done;
    }
    PyTypeObject *cls = (PyTypeObject *)cls_obj;
    if (!PyType_IsSubtype(cls, &PyTuple_Type)) {
        PyErr_SetString(PyExc_TypeError, "cls must subclass tuple");
        goto done;
    }
    const int64_t *vid = (const int64_t *)vb.buf;
    const double *ds = (const double *)db.buf;
    const double *fq = (const double *)fb.buf;
    const int64_t *bounds = (const int64_t *)bb.buf;
    Py_ssize_t n = (Py_ssize_t)(vb.len / (Py_ssize_t)sizeof(int64_t));
    if (nrows < 0 || bb.len < (nrows + 1) * (Py_ssize_t)sizeof(int64_t) ||
        db.len < n * (Py_ssize_t)sizeof(double) ||
        fb.len < n * (Py_ssize_t)sizeof(double)) {
        PyErr_SetString(PyExc_ValueError, "column/bounds length mismatch");
        goto done;
    }

    outer = PyList_New(nrows);
    if (!outer)
        goto done;
    for (Py_ssize_t g = 0; g < nrows; g++) {
        int64_t lo = bounds[g], hi = bounds[g + 1];
        if (lo < 0 || hi < lo || hi > (int64_t)n) {
            PyErr_SetString(PyExc_ValueError, "bounds out of range");
            goto fail;
        }
        PyObject *inner = PyList_New((Py_ssize_t)(hi - lo));
        if (!inner)
            goto fail;
        PyList_SET_ITEM(outer, g, inner); /* owned by outer from here on */
        for (int64_t i = lo; i < hi; i++) {
            /* tuple-subtype construction as CPython's tuple_subtype_new
             * does it: tp_alloc(cls, 4) then fill the slots directly */
            PyObject *vr = cls->tp_alloc(cls, 4);
            if (!vr)
                goto fail;
            PyList_SET_ITEM(inner, (Py_ssize_t)(i - lo), vr);
            PyObject *o0 = PyLong_FromLongLong((long long)vid[i]);
            PyObject *o1 = PyFloat_FromDouble(ds[i]);
            PyObject *o2 = PyFloat_FromDouble(fq[i]);
            if (!o0 || !o1 || !o2) {
                Py_XDECREF(o0);
                Py_XDECREF(o1);
                Py_XDECREF(o2);
                goto fail;
            }
            PyTuple_SET_ITEM(vr, 0, o0);
            PyTuple_SET_ITEM(vr, 1, o1);
            PyTuple_SET_ITEM(vr, 2, o2);
            Py_INCREF(Py_None);
            PyTuple_SET_ITEM(vr, 3, Py_None);
        }
    }
    goto done;

fail:
    Py_CLEAR(outer);
done:
    PyBuffer_Release(&vb);
    PyBuffer_Release(&db);
    PyBuffer_Release(&fb);
    PyBuffer_Release(&bb);
    return outer;
}

static PyMethodDef methods[] = {
    {"build_result_lists", build_result_lists, METH_VARARGS,
     "Bulk-construct per-query result lists from flat survivor columns."},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_fastemit_torch", NULL, -1, methods,
};

PyMODINIT_FUNC
PyInit__fastemit_torch(void)
{
    return PyModule_Create(&moduledef);
}
