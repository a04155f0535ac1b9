/* Native IO runtime: binary PLY scene loader/saver + PNG writer.
 *
 * A copy of mojosplat_tpu/native/io_native.c for the PyTorch port, built
 * into build/ by mojosplat_tpu_torch/native/__init__.py. A zero-copy
 * binary-PLY parser for the standard 3D-Gaussian-Splatting scene format
 * and a dependency-free PNG encoder (stored-deflate, CRC32/Adler32
 * implemented inline).
 *
 * The API is deliberately bytes-based (no NumPy C API): Python wrappers in
 * mojosplat_tpu_torch/utils/ply.py and utils/image.py do the array viewing,
 * and carry pure-Python versions for environments without a C toolchain.
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

/* ------------------------------------------------------------------ PLY */

#define MAX_PROPS 256
#define MAX_LINE 512

static PyObject *
load_ply(PyObject *self, PyObject *args)
{
    const char *path;
    if (!PyArg_ParseTuple(args, "s", &path))
        return NULL;

    FILE *f = fopen(path, "rb");
    if (!f)
        return PyErr_Format(PyExc_FileNotFoundError, "cannot open %s", path);

    char line[MAX_LINE];
    long n_vertex = -1;
    int n_props = 0;
    int in_vertex = 0;
    PyObject *names = PyList_New(0);
    if (!names) {
        fclose(f);
        return NULL;
    }

    if (!fgets(line, MAX_LINE, f) || strncmp(line, "ply", 3) != 0) {
        fclose(f);
        Py_DECREF(names);
        return PyErr_Format(PyExc_ValueError, "%s: not a PLY file", path);
    }

    int ok_format = 0;
    for (;;) {
        if (!fgets(line, MAX_LINE, f)) {
            fclose(f);
            Py_DECREF(names);
            return PyErr_Format(PyExc_ValueError,
                                "%s: unexpected EOF in header", path);
        }
        if (strncmp(line, "comment", 7) == 0)
            continue;
        if (strncmp(line, "format", 6) == 0) {
            if (strstr(line, "binary_little_endian") == NULL) {
                fclose(f);
                Py_DECREF(names);
                return PyErr_Format(
                    PyExc_ValueError,
                    "%s: only binary_little_endian PLY is supported", path);
            }
            ok_format = 1;
            continue;
        }
        if (strncmp(line, "element", 7) == 0) {
            char elem[64];
            long count;
            if (sscanf(line, "element %63s %ld", elem, &count) == 2) {
                if (strcmp(elem, "vertex") == 0) {
                    n_vertex = count;
                    in_vertex = 1;
                } else if (count > 0) {
                    fclose(f);
                    Py_DECREF(names);
                    return PyErr_Format(
                        PyExc_ValueError,
                        "%s: unsupported non-empty element '%s'", path, elem);
                } else {
                    in_vertex = 0;
                }
            }
            continue;
        }
        if (strncmp(line, "property", 8) == 0) {
            if (!in_vertex)
                continue;
            char type[32], name[128];
            if (sscanf(line, "property %31s %127s", type, name) != 2 ||
                strcmp(type, "float") != 0) {
                fclose(f);
                Py_DECREF(names);
                return PyErr_Format(
                    PyExc_ValueError,
                    "%s: only 'property float' supported (got %s)", path,
                    line);
            }
            if (n_props >= MAX_PROPS) {
                fclose(f);
                Py_DECREF(names);
                return PyErr_Format(PyExc_ValueError,
                                    "%s: too many properties", path);
            }
            PyObject *s = PyUnicode_FromString(name);
            if (!s || PyList_Append(names, s) < 0) {
                Py_XDECREF(s);
                fclose(f);
                Py_DECREF(names);
                return NULL;
            }
            Py_DECREF(s);
            n_props++;
            continue;
        }
        if (strncmp(line, "end_header", 10) == 0)
            break;
    }

    if (!ok_format || n_vertex < 0 || n_props == 0) {
        fclose(f);
        Py_DECREF(names);
        return PyErr_Format(PyExc_ValueError, "%s: malformed PLY header",
                            path);
    }

    size_t nbytes = (size_t)n_vertex * (size_t)n_props * 4u;
    PyObject *blob = PyBytes_FromStringAndSize(NULL, (Py_ssize_t)nbytes);
    if (!blob) {
        fclose(f);
        Py_DECREF(names);
        return NULL;
    }
    size_t got = fread(PyBytes_AS_STRING(blob), 1, nbytes, f);
    fclose(f);
    if (got != nbytes) {
        Py_DECREF(blob);
        Py_DECREF(names);
        return PyErr_Format(PyExc_ValueError,
                            "%s: truncated payload (%zu of %zu bytes)", path,
                            got, nbytes);
    }
    PyObject *out = Py_BuildValue("(OlN)", names, n_vertex, blob);
    Py_DECREF(names);
    return out;
}

static PyObject *
save_ply(PyObject *self, PyObject *args)
{
    const char *path;
    PyObject *names;
    long n_vertex;
    Py_buffer data;
    if (!PyArg_ParseTuple(args, "sO!ly*", &path, &PyList_Type, &names,
                          &n_vertex, &data))
        return NULL;

    Py_ssize_t n_props = PyList_GET_SIZE(names);
    if ((Py_ssize_t)data.len != (Py_ssize_t)(n_vertex * n_props * 4)) {
        PyBuffer_Release(&data);
        return PyErr_Format(PyExc_ValueError,
                            "payload size mismatch: %zd bytes for %ld x %zd",
                            data.len, n_vertex, n_props);
    }
    FILE *f = fopen(path, "wb");
    if (!f) {
        PyBuffer_Release(&data);
        return PyErr_Format(PyExc_OSError, "cannot write %s", path);
    }
    fprintf(f, "ply\nformat binary_little_endian 1.0\n");
    fprintf(f, "element vertex %ld\n", n_vertex);
    for (Py_ssize_t i = 0; i < n_props; i++) {
        PyObject *s = PyList_GET_ITEM(names, i);
        const char *nm = PyUnicode_AsUTF8(s);
        if (!nm) {
            fclose(f);
            PyBuffer_Release(&data);
            return NULL;
        }
        fprintf(f, "property float %s\n", nm);
    }
    fprintf(f, "end_header\n");
    size_t wrote = fwrite(data.buf, 1, (size_t)data.len, f);
    fclose(f);
    Py_ssize_t expect = data.len;
    PyBuffer_Release(&data);
    if ((Py_ssize_t)wrote != expect)
        return PyErr_Format(PyExc_OSError, "short write to %s", path);
    Py_RETURN_NONE;
}

/* ------------------------------------------------------------------ PNG */

static uint32_t crc_table[256];
static int crc_table_ready = 0;

static void
crc_init(void)
{
    for (uint32_t n = 0; n < 256; n++) {
        uint32_t c = n;
        for (int k = 0; k < 8; k++)
            c = (c & 1) ? 0xedb88320u ^ (c >> 1) : c >> 1;
        crc_table[n] = c;
    }
    crc_table_ready = 1;
}

static uint32_t
crc32_update(uint32_t crc, const uint8_t *buf, size_t len)
{
    uint32_t c = crc;
    for (size_t i = 0; i < len; i++)
        c = crc_table[(c ^ buf[i]) & 0xff] ^ (c >> 8);
    return c;
}

static void
put_be32(uint8_t *p, uint32_t v)
{
    p[0] = (uint8_t)(v >> 24);
    p[1] = (uint8_t)(v >> 16);
    p[2] = (uint8_t)(v >> 8);
    p[3] = (uint8_t)v;
}

static int
write_chunk(FILE *f, const char *tag, const uint8_t *payload, size_t len)
{
    uint8_t hdr[8];
    put_be32(hdr, (uint32_t)len);
    memcpy(hdr + 4, tag, 4);
    if (fwrite(hdr, 1, 8, f) != 8)
        return -1;
    if (len && fwrite(payload, 1, len, f) != len)
        return -1;
    uint32_t crc = 0xffffffffu;
    crc = crc32_update(crc, (const uint8_t *)tag, 4);
    if (len)
        crc = crc32_update(crc, payload, len);
    uint8_t crcb[4];
    put_be32(crcb, crc ^ 0xffffffffu);
    return fwrite(crcb, 1, 4, f) == 4 ? 0 : -1;
}

static PyObject *
write_png(PyObject *self, PyObject *args)
{
    const char *path;
    long H, W, C;
    Py_buffer data;
    if (!PyArg_ParseTuple(args, "sllly*", &path, &H, &W, &C, &data))
        return NULL;
    if (!crc_table_ready)
        crc_init();

    if (C != 1 && C != 3 && C != 4) {
        PyBuffer_Release(&data);
        return PyErr_Format(PyExc_ValueError, "channels must be 1/3/4, got %ld",
                            C);
    }
    if ((long)data.len != H * W * C) {
        PyBuffer_Release(&data);
        return PyErr_Format(PyExc_ValueError,
                            "buffer is %zd bytes, expected %ld", data.len,
                            H * W * C);
    }

    /* Raw scanline stream: per-row filter byte 0 + pixels. */
    size_t row = (size_t)W * (size_t)C;
    size_t rawlen = (size_t)H * (row + 1);
    uint8_t *raw = (uint8_t *)malloc(rawlen);
    if (!raw) {
        PyBuffer_Release(&data);
        return PyErr_NoMemory();
    }
    const uint8_t *src = (const uint8_t *)data.buf;
    for (long y = 0; y < H; y++) {
        raw[y * (row + 1)] = 0;
        memcpy(raw + y * (row + 1) + 1, src + (size_t)y * row, row);
    }
    PyBuffer_Release(&data);

    /* zlib stream with stored (uncompressed) deflate blocks. */
    size_t nblocks = (rawlen + 65534) / 65535;
    if (nblocks == 0)
        nblocks = 1;
    size_t zlen = 2 + rawlen + nblocks * 5 + 4;
    uint8_t *z = (uint8_t *)malloc(zlen);
    if (!z) {
        free(raw);
        return PyErr_NoMemory();
    }
    size_t zi = 0;
    z[zi++] = 0x78;
    z[zi++] = 0x01;
    size_t off = 0;
    uint32_t s1 = 1, s2 = 0;
    do {
        size_t blk = rawlen - off;
        if (blk > 65535)
            blk = 65535;
        int final = (off + blk == rawlen);
        z[zi++] = (uint8_t)(final ? 1 : 0);
        z[zi++] = (uint8_t)(blk & 0xff);
        z[zi++] = (uint8_t)(blk >> 8);
        z[zi++] = (uint8_t)(~blk & 0xff);
        z[zi++] = (uint8_t)((~blk >> 8) & 0xff);
        memcpy(z + zi, raw + off, blk);
        /* Adler-32 over the raw stream. */
        for (size_t i = 0; i < blk; i++) {
            s1 = (s1 + raw[off + i]) % 65521u;
            s2 = (s2 + s1) % 65521u;
        }
        zi += blk;
        off += blk;
    } while (off < rawlen);
    put_be32(z + zi, (s2 << 16) | s1);
    zi += 4;
    free(raw);

    FILE *f = fopen(path, "wb");
    if (!f) {
        free(z);
        return PyErr_Format(PyExc_OSError, "cannot write %s", path);
    }
    static const uint8_t sig[8] = {137, 80, 78, 71, 13, 10, 26, 10};
    int err = fwrite(sig, 1, 8, f) != 8;

    uint8_t ihdr[13];
    put_be32(ihdr, (uint32_t)W);
    put_be32(ihdr + 4, (uint32_t)H);
    ihdr[8] = 8; /* bit depth */
    ihdr[9] = (C == 1) ? 0 : (C == 3 ? 2 : 6); /* gray / rgb / rgba */
    ihdr[10] = ihdr[11] = ihdr[12] = 0;
    err |= write_chunk(f, "IHDR", ihdr, 13) != 0;
    err |= write_chunk(f, "IDAT", z, zi) != 0;
    err |= write_chunk(f, "IEND", NULL, 0) != 0;
    free(z);
    err |= fclose(f) != 0;
    if (err)
        return PyErr_Format(PyExc_OSError, "failed writing %s", path);
    Py_RETURN_NONE;
}

/* --------------------------------------------------------------- COLMAP */

/* Binary COLMAP sparse-reconstruction parsers (cameras.bin / images.bin /
 * points3D.bin) — the standard SfM input of 3DGS training pipelines: the
 * native data-loader runtime for training on real captures. Bytes-based API
 * like the PLY loader; mojosplat_tpu_torch/utils/colmap.py does the array
 * viewing and carries a pure-Python version. */

static int
colmap_num_params(int model_id)
{
    switch (model_id) {
    case 0: return 3;   /* SIMPLE_PINHOLE: f, cx, cy */
    case 1: return 4;   /* PINHOLE: fx, fy, cx, cy */
    case 2: return 4;   /* SIMPLE_RADIAL */
    case 3: return 5;   /* RADIAL */
    case 4: return 8;   /* OPENCV */
    case 5: return 8;   /* OPENCV_FISHEYE */
    case 6: return 12;  /* FULL_OPENCV */
    case 7: return 5;   /* FOV */
    case 8: return 4;   /* SIMPLE_RADIAL_FISHEYE */
    case 9: return 5;   /* RADIAL_FISHEYE */
    case 10: return 12; /* THIN_PRISM_FISHEYE */
    default: return -1;
    }
}

static int
read_exact(FILE *f, void *dst, size_t n)
{
    return fread(dst, 1, n, f) == n ? 0 : -1;
}

static PyObject *
load_colmap_cameras(PyObject *self, PyObject *args)
{
    const char *path;
    if (!PyArg_ParseTuple(args, "s", &path))
        return NULL;
    FILE *f = fopen(path, "rb");
    if (!f)
        return PyErr_Format(PyExc_FileNotFoundError, "cannot open %s", path);

    uint64_t n;
    if (read_exact(f, &n, 8)) {
        fclose(f);
        return PyErr_Format(PyExc_ValueError, "%s: truncated header", path);
    }
    PyObject *out = PyList_New(0);
    if (!out) {
        fclose(f);
        return NULL;
    }
    for (uint64_t i = 0; i < n; i++) {
        int32_t cam_id, model_id;
        uint64_t width, height;
        double params[12];
        if (read_exact(f, &cam_id, 4) || read_exact(f, &model_id, 4) ||
            read_exact(f, &width, 8) || read_exact(f, &height, 8))
            goto trunc;
        int np = colmap_num_params(model_id);
        if (np < 0) {
            fclose(f);
            Py_DECREF(out);
            return PyErr_Format(PyExc_ValueError,
                                "%s: unknown camera model %d", path,
                                (int)model_id);
        }
        if (read_exact(f, params, 8 * (size_t)np))
            goto trunc;
        PyObject *rec = Py_BuildValue(
            "iiKKy#", (int)cam_id, (int)model_id,
            (unsigned long long)width, (unsigned long long)height,
            (const char *)params, (Py_ssize_t)(8 * np));
        if (!rec || PyList_Append(out, rec) < 0) {
            Py_XDECREF(rec);
            fclose(f);
            Py_DECREF(out);
            return NULL;
        }
        Py_DECREF(rec);
    }
    fclose(f);
    return out;
trunc:
    fclose(f);
    Py_DECREF(out);
    return PyErr_Format(PyExc_ValueError, "%s: truncated record", path);
}

static PyObject *
load_colmap_images(PyObject *self, PyObject *args)
{
    const char *path;
    if (!PyArg_ParseTuple(args, "s", &path))
        return NULL;
    FILE *f = fopen(path, "rb");
    if (!f)
        return PyErr_Format(PyExc_FileNotFoundError, "cannot open %s", path);

    uint64_t n;
    if (read_exact(f, &n, 8)) {
        fclose(f);
        return PyErr_Format(PyExc_ValueError, "%s: truncated header", path);
    }
    int32_t *ids = (int32_t *)malloc(n * 4 ? n * 4 : 4);
    int32_t *cam_ids = (int32_t *)malloc(n * 4 ? n * 4 : 4);
    double *qvecs = (double *)malloc(n * 32 ? n * 32 : 8);
    double *tvecs = (double *)malloc(n * 24 ? n * 24 : 8);
    PyObject *names = PyList_New(0);
    if (!ids || !cam_ids || !qvecs || !tvecs || !names)
        goto fail;

    for (uint64_t i = 0; i < n; i++) {
        if (read_exact(f, &ids[i], 4) || read_exact(f, &qvecs[i * 4], 32) ||
            read_exact(f, &tvecs[i * 3], 24) || read_exact(f, &cam_ids[i], 4))
            goto trunc;
        char name[1024];
        size_t ni = 0;
        for (;;) {
            int c = fgetc(f);
            if (c == EOF)
                goto trunc;
            if (c == 0)
                break;
            if (ni < sizeof(name) - 1)
                name[ni++] = (char)c;
        }
        name[ni] = 0;
        PyObject *s = PyUnicode_DecodeUTF8(name, (Py_ssize_t)ni, "replace");
        if (!s || PyList_Append(names, s) < 0) {
            Py_XDECREF(s);
            goto fail;
        }
        Py_DECREF(s);
        uint64_t npts;
        if (read_exact(f, &npts, 8))
            goto trunc;
        /* Skip the 2D observations: (double x, double y, int64 p3d_id). */
        if (fseek(f, (long)(npts * 24), SEEK_CUR) != 0)
            goto trunc;
    }
    fclose(f);
    {
        PyObject *out = Py_BuildValue(
            "Ky#y#y#y#N", (unsigned long long)n,
            (const char *)ids, (Py_ssize_t)(n * 4),
            (const char *)qvecs, (Py_ssize_t)(n * 32),
            (const char *)tvecs, (Py_ssize_t)(n * 24),
            (const char *)cam_ids, (Py_ssize_t)(n * 4), names);
        free(ids); free(cam_ids); free(qvecs); free(tvecs);
        return out;
    }
trunc:
    fclose(f);
    free(ids); free(cam_ids); free(qvecs); free(tvecs);
    Py_XDECREF(names);
    return PyErr_Format(PyExc_ValueError, "%s: truncated record", path);
fail:
    fclose(f);
    free(ids); free(cam_ids); free(qvecs); free(tvecs);
    Py_XDECREF(names);
    return PyErr_NoMemory();
}

static PyObject *
load_colmap_points(PyObject *self, PyObject *args)
{
    const char *path;
    if (!PyArg_ParseTuple(args, "s", &path))
        return NULL;
    FILE *f = fopen(path, "rb");
    if (!f)
        return PyErr_Format(PyExc_FileNotFoundError, "cannot open %s", path);

    uint64_t n;
    if (read_exact(f, &n, 8)) {
        fclose(f);
        return PyErr_Format(PyExc_ValueError, "%s: truncated header", path);
    }
    double *xyz = (double *)malloc(n * 24 ? n * 24 : 8);
    uint8_t *rgb = (uint8_t *)malloc(n * 3 ? n * 3 : 4);
    if (!xyz || !rgb) {
        fclose(f);
        free(xyz); free(rgb);
        return PyErr_NoMemory();
    }
    for (uint64_t i = 0; i < n; i++) {
        int64_t pid;
        double err;
        uint64_t track;
        if (read_exact(f, &pid, 8) || read_exact(f, &xyz[i * 3], 24) ||
            read_exact(f, &rgb[i * 3], 3) || read_exact(f, &err, 8) ||
            read_exact(f, &track, 8) ||
            fseek(f, (long)(track * 8), SEEK_CUR) != 0) {
            fclose(f);
            free(xyz); free(rgb);
            return PyErr_Format(PyExc_ValueError, "%s: truncated record",
                                path);
        }
    }
    fclose(f);
    PyObject *out = Py_BuildValue(
        "Ky#y#", (unsigned long long)n, (const char *)xyz,
        (Py_ssize_t)(n * 24), (const char *)rgb, (Py_ssize_t)(n * 3));
    free(xyz); free(rgb);
    return out;
}

/* ----------------------------------------------------------------- init */

static PyMethodDef methods[] = {
    {"load_ply", load_ply, METH_VARARGS,
     "load_ply(path) -> (property_names, n_vertex, float32_le_bytes)"},
    {"save_ply", save_ply, METH_VARARGS,
     "save_ply(path, property_names, n_vertex, float32_le_bytes)"},
    {"write_png", write_png, METH_VARARGS,
     "write_png(path, H, W, C, uint8_bytes)"},
    {"load_colmap_cameras", load_colmap_cameras, METH_VARARGS,
     "load_colmap_cameras(path) -> [(camera_id, model_id, width, height, "
     "params_f64le_bytes)]"},
    {"load_colmap_images", load_colmap_images, METH_VARARGS,
     "load_colmap_images(path) -> (n, ids_i32, qvecs_f64 (n,4) wxyz, "
     "tvecs_f64 (n,3), camera_ids_i32, names)"},
    {"load_colmap_points", load_colmap_points, METH_VARARGS,
     "load_colmap_points(path) -> (n, xyz_f64 (n,3), rgb_u8 (n,3))"},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef module = {
    PyModuleDef_HEAD_INIT, "_io_native",
    "Native PLY/PNG/COLMAP IO runtime for mojosplat_tpu_torch", -1, methods,
};

PyMODINIT_FUNC
PyInit__io_native(void)
{
    return PyModule_Create(&module);
}
