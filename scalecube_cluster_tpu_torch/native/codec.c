/* Compact binary message codec — the wire-format hot path in C.
 *
 * The reference's per-message hot path runs on Netty's native
 * epoll/zero-copy layer with pluggable MessageCodecs
 * (TransportImpl.java:240-260); this extension is the analogue for the
 * asyncio TCP transport: header-map + payload packing without pickling
 * overhead, and a language-neutral format (a non-Python peer can speak it).
 *
 * Wire format (all big-endian):
 *   magic   2 bytes  'S''1'
 *   hcount  u16      number of headers
 *   per header:  klen u16, key bytes (utf-8), vlen u32, value bytes (utf-8)
 *   plen    u32      payload length, then payload bytes
 *
 * Python-level contract (mirrored by the pure-Python fallback in
 * transport/native_codec.py):
 *   encode(headers: dict[str, str], payload: bytes) -> bytes
 *   decode(buf: bytes) -> (dict[str, str], bytes)
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <string.h>

static void put_u16(unsigned char *p, unsigned int v) {
    p[0] = (v >> 8) & 0xff; p[1] = v & 0xff;
}
static void put_u32(unsigned char *p, unsigned long v) {
    p[0] = (v >> 24) & 0xff; p[1] = (v >> 16) & 0xff;
    p[2] = (v >> 8) & 0xff;  p[3] = v & 0xff;
}
static unsigned int get_u16(const unsigned char *p) {
    return ((unsigned int)p[0] << 8) | p[1];
}
static unsigned long get_u32(const unsigned char *p) {
    return ((unsigned long)p[0] << 24) | ((unsigned long)p[1] << 16)
         | ((unsigned long)p[2] << 8) | p[3];
}

static PyObject *codec_encode(PyObject *self, PyObject *args) {
    PyObject *headers; Py_buffer payload;
    if (!PyArg_ParseTuple(args, "O!y*", &PyDict_Type, &headers, &payload))
        return NULL;

    Py_ssize_t hcount = PyDict_Size(headers);
    if (hcount > 0xffff) {
        PyBuffer_Release(&payload);
        PyErr_SetString(PyExc_ValueError, "too many headers");
        return NULL;
    }

    /* first pass: compute size, grab utf-8 views (owned refs kept in a list) */
    PyObject *pairs = PyList_New(0);
    if (!pairs) { PyBuffer_Release(&payload); return NULL; }
    Py_ssize_t total = 2 + 2 + 4 + payload.len;
    PyObject *key, *value; Py_ssize_t pos = 0;
    while (PyDict_Next(headers, &pos, &key, &value)) {
        if (!PyUnicode_Check(key) || !PyUnicode_Check(value)) {
            Py_DECREF(pairs); PyBuffer_Release(&payload);
            PyErr_SetString(PyExc_TypeError, "headers must be str->str");
            return NULL;
        }
        Py_ssize_t klen, vlen;
        const char *k = PyUnicode_AsUTF8AndSize(key, &klen);
        const char *v = PyUnicode_AsUTF8AndSize(value, &vlen);
        if (!k || !v || klen > 0xffff || vlen > 0xffffffffL) {
            Py_DECREF(pairs); PyBuffer_Release(&payload);
            if (!PyErr_Occurred())
                PyErr_SetString(PyExc_ValueError, "header too large");
            return NULL;
        }
        PyObject *pair = Py_BuildValue("(OO)", key, value);
        if (!pair || PyList_Append(pairs, pair) < 0) {
            Py_XDECREF(pair); Py_DECREF(pairs); PyBuffer_Release(&payload);
            return NULL;
        }
        Py_DECREF(pair);
        total += 2 + klen + 4 + vlen;
    }

    PyObject *out = PyBytes_FromStringAndSize(NULL, total);
    if (!out) { Py_DECREF(pairs); PyBuffer_Release(&payload); return NULL; }
    unsigned char *p = (unsigned char *)PyBytes_AS_STRING(out);
    *p++ = 'S'; *p++ = '1';
    put_u16(p, (unsigned int)hcount); p += 2;
    for (Py_ssize_t i = 0; i < PyList_GET_SIZE(pairs); i++) {
        PyObject *pair = PyList_GET_ITEM(pairs, i);
        Py_ssize_t klen, vlen;
        const char *k = PyUnicode_AsUTF8AndSize(PyTuple_GET_ITEM(pair, 0), &klen);
        const char *v = PyUnicode_AsUTF8AndSize(PyTuple_GET_ITEM(pair, 1), &vlen);
        put_u16(p, (unsigned int)klen); p += 2;
        memcpy(p, k, klen); p += klen;
        put_u32(p, (unsigned long)vlen); p += 4;
        memcpy(p, v, vlen); p += vlen;
    }
    put_u32(p, (unsigned long)payload.len); p += 4;
    memcpy(p, payload.buf, payload.len);
    Py_DECREF(pairs);
    PyBuffer_Release(&payload);
    return out;
}

static PyObject *codec_decode(PyObject *self, PyObject *args) {
    Py_buffer buf;
    if (!PyArg_ParseTuple(args, "y*", &buf))
        return NULL;
    const unsigned char *p = (const unsigned char *)buf.buf;
    const unsigned char *end = p + buf.len;

    if (buf.len < 8 || p[0] != 'S' || p[1] != '1') {
        PyBuffer_Release(&buf);
        PyErr_SetString(PyExc_ValueError, "bad magic");
        return NULL;
    }
    p += 2;
    unsigned int hcount = get_u16(p); p += 2;

    PyObject *headers = PyDict_New();
    if (!headers) { PyBuffer_Release(&buf); return NULL; }
    for (unsigned int i = 0; i < hcount; i++) {
        if (p + 2 > end) goto truncated;
        unsigned int klen = get_u16(p); p += 2;
        if (p + klen + 4 > end) goto truncated;
        PyObject *k = PyUnicode_DecodeUTF8((const char *)p, klen, "strict");
        p += klen;
        unsigned long vlen = get_u32(p); p += 4;
        if (!k || p + vlen > end) { Py_XDECREF(k); goto truncated; }
        PyObject *v = PyUnicode_DecodeUTF8((const char *)p, vlen, "strict");
        p += vlen;
        if (!v || PyDict_SetItem(headers, k, v) < 0) {
            Py_DECREF(k); Py_XDECREF(v);
            Py_DECREF(headers); PyBuffer_Release(&buf);
            return NULL;
        }
        Py_DECREF(k); Py_DECREF(v);
    }
    if (p + 4 > end) goto truncated;
    {
        unsigned long plen = get_u32(p); p += 4;
        if (p + plen > end) goto truncated;
        PyObject *payload = PyBytes_FromStringAndSize((const char *)p, plen);
        PyBuffer_Release(&buf);
        if (!payload) { Py_DECREF(headers); return NULL; }
        PyObject *result = Py_BuildValue("(NN)", headers, payload);
        return result;
    }

truncated:
    Py_DECREF(headers);
    PyBuffer_Release(&buf);
    if (!PyErr_Occurred())
        PyErr_SetString(PyExc_ValueError, "truncated frame");
    return NULL;
}

static PyMethodDef codec_methods[] = {
    {"encode", codec_encode, METH_VARARGS,
     "encode(headers: dict[str, str], payload: bytes) -> bytes"},
    {"decode", codec_decode, METH_VARARGS,
     "decode(buf: bytes) -> (dict[str, str], bytes)"},
    {NULL, NULL, 0, NULL}
};

static struct PyModuleDef codec_module = {
    PyModuleDef_HEAD_INIT, "_sc_codec",
    "Native binary message codec for scalecube_cluster_tpu_torch", -1, codec_methods
};

PyMODINIT_FUNC PyInit__sc_codec(void) {
    return PyModule_Create(&codec_module);
}
