/*
 * qshost — native host runtime for the jpegqs_tpu_torch package (a copy
 * of the jpegqs_tpu runtime, so the PyTorch port stands alone).
 *
 * Role: everything the device engine does NOT do — JPEG container I/O.
 * Entropy decode/encode stays on the host (mirrors the reference's
 * architecture where do_quantsmooth operates purely on coefficient
 * planes: quantsmooth.c:548-579). This library exposes
 * quantized DCT coefficient planes + quant tables to Python (ctypes),
 * accepts modified coefficient planes back, and re-encodes with all
 * quantization tables set to 1 (reference: quantsmooth.h:2851-2859).
 *
 * Marker copy policy mirrors the reference CLI
 * (quantsmooth.c:541-546 save, 581-590 write with JFIF/Adobe dedup).
 *
 * UPSAMPLE_UV support: chroma coefficient arrays can be replaced with
 * full-resolution planes and the component sampling factors rewritten
 * to 1x1 (reference: quantsmooth.h:2691-2752, 2836-2849).
 *
 * This is new code written for this framework; it shares no
 * implementation with the reference (which never had a C API like this).
 */

#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <setjmp.h>
#include <stdint.h>
#include <jpeglib.h>
#include <jerror.h>

#define QS_EXPORT __attribute__((visibility("default")))

typedef struct {
    struct jpeg_decompress_struct srcinfo;
    struct jpeg_error_mgr jerr;
    jmp_buf env;
    char errmsg[JMSG_LENGTH_MAX];
    jvirt_barray_ptr *coef_arrays;
    /* replacement full-res chroma arrays for UPSAMPLE_UV (index = ci-1) */
    jvirt_barray_ptr coef_up[2];
    int upsampled;
    uint8_t *input_copy;
    int open_ok;
    int verbose;
    int32_t extra_warnings;  /* encode-side warnings from qs_save */
    /* qs_save state kept on the heap so the longjmp error path can
     * restore/free it (locals mutated after setjmp are indeterminate
     * after longjmp) */
    uint16_t saved_q[NUM_QUANT_TBLS][DCTSIZE2];
    int saved_mask;
    unsigned char *save_buf;
    unsigned long save_bufsize;
} qs_handle;

/* undo qs_save's in-place all-1 quantval mutation (both table views) */
static void qs_restore_qtables(qs_handle *h) {
    int ci;
    for (ci = 0; ci < NUM_QUANT_TBLS; ci++) {
        if (!(h->saved_mask & (1 << ci))) continue;
        memcpy(h->srcinfo.quant_tbl_ptrs[ci]->quantval, h->saved_q[ci],
               sizeof(h->saved_q[ci]));
    }
    for (ci = 0; ci < h->srcinfo.num_components; ci++) {
        jpeg_component_info *c = h->srcinfo.comp_info + ci;
        if (c->quant_table && (h->saved_mask & (1 << c->quant_tbl_no)))
            memcpy(c->quant_table->quantval, h->saved_q[c->quant_tbl_no],
                   sizeof(h->saved_q[0]));
    }
    h->saved_mask = 0;
}

typedef struct {
    int32_t image_width;
    int32_t image_height;
    int32_t num_components;
    int32_t jpeg_color_space;  /* J_COLOR_SPACE enum value; JCS_YCbCr == 3 */
    int32_t progressive_mode;
    int32_t max_h_samp_factor;
    int32_t max_v_samp_factor;
    int32_t num_warnings;
} qs_info;

typedef struct {
    int32_t component_id;
    int32_t h_samp_factor;
    int32_t v_samp_factor;
    int32_t quant_tbl_no;
    int32_t width_in_blocks;
    int32_t height_in_blocks;
    uint16_t quantval[DCTSIZE2];  /* natural order, as stored by libjpeg */
} qs_comp_info;

static void qs_error_exit(j_common_ptr cinfo) {
    qs_handle *h = (qs_handle *)cinfo->client_data;
    (*cinfo->err->format_message)(cinfo, h->errmsg);
    longjmp(h->env, 1);
}

/* libjpeg's default emit_message semantics (count corrupt-data warnings,
 * honor trace_level) but never aborting on output: matches the reference
 * CLI, whose exit code is num_warnings ? 2 : 0 (quantsmooth.c:626) and
 * whose trace verbosity comes from --verbose (quantsmooth.c:498). */
static void qs_emit_message(j_common_ptr cinfo, int msg_level) {
    struct jpeg_error_mgr *err = cinfo->err;
    if (msg_level < 0) {
        if (err->num_warnings == 0 || err->trace_level >= 3)
            (*err->output_message)(cinfo);
        err->num_warnings++;
    } else {
        if (err->trace_level >= msg_level)
            (*err->output_message)(cinfo);
    }
}

QS_EXPORT qs_handle *qs_open(const uint8_t *data, size_t size,
                             int copy_markers, int verbose) {
    qs_handle *h = (qs_handle *)calloc(1, sizeof(qs_handle));
    if (!h) return NULL;
    h->srcinfo.err = jpeg_std_error(&h->jerr);
    h->jerr.error_exit = qs_error_exit;
    h->jerr.emit_message = qs_emit_message;
    h->jerr.trace_level = verbose;
    h->verbose = verbose;
    h->srcinfo.client_data = h;
    if (setjmp(h->env)) {
        /* error during open: keep handle alive so caller can read errmsg */
        h->open_ok = 0;
        return h;
    }
    jpeg_create_decompress(&h->srcinfo);
    /* keep our own copy of the input; libjpeg reads lazily */
    h->input_copy = (uint8_t *)malloc(size);
    if (!h->input_copy) { strcpy(h->errmsg, "out of memory"); return h; }
    memcpy(h->input_copy, data, size);
    jpeg_mem_src(&h->srcinfo, h->input_copy, (unsigned long)size);
    /* marker copy policy: reference quantsmooth.c:541-546 */
    if (copy_markers > 0) jpeg_save_markers(&h->srcinfo, JPEG_COM, 0xFFFF);
    if (copy_markers > 1) {
        int i;
        for (i = 0; i < 16; i++)
            jpeg_save_markers(&h->srcinfo, JPEG_APP0 + i, 0xFFFF);
    }
    jpeg_read_header(&h->srcinfo, TRUE);
    h->coef_arrays = jpeg_read_coefficients(&h->srcinfo);
    h->open_ok = (h->coef_arrays != NULL);
    return h;
}

QS_EXPORT int qs_ok(qs_handle *h) { return h && h->open_ok; }

QS_EXPORT const char *qs_error(qs_handle *h) { return h ? h->errmsg : "null handle"; }

QS_EXPORT void qs_get_info(qs_handle *h, qs_info *out) {
    struct jpeg_decompress_struct *s = &h->srcinfo;
    out->image_width = s->image_width;
    out->image_height = s->image_height;
    out->num_components = s->num_components;
    out->jpeg_color_space = s->jpeg_color_space;
    out->progressive_mode = s->progressive_mode;
    out->max_h_samp_factor = s->max_h_samp_factor;
    out->max_v_samp_factor = s->max_v_samp_factor;
    out->num_warnings = (int32_t)s->err->num_warnings;
}

QS_EXPORT int qs_get_comp_info(qs_handle *h, int ci, qs_comp_info *out) {
    jpeg_component_info *c;
    if (ci < 0 || ci >= h->srcinfo.num_components) return -1;
    c = h->srcinfo.comp_info + ci;
    out->component_id = c->component_id;
    out->h_samp_factor = c->h_samp_factor;
    out->v_samp_factor = c->v_samp_factor;
    out->quant_tbl_no = c->quant_tbl_no;
    out->width_in_blocks = c->width_in_blocks;
    out->height_in_blocks = c->height_in_blocks;
    if (c->quant_table) {
        memcpy(out->quantval, c->quant_table->quantval, sizeof(out->quantval));
    } else {
        memset(out->quantval, 0, sizeof(out->quantval));
    }
    return 0;
}

/* Copy one component's coefficient blocks out, natural order per block,
 * shape [height_in_blocks, width_in_blocks, 64] int16. */
QS_EXPORT int qs_read_coefs(qs_handle *h, int ci, int16_t *out) {
    JDIMENSION by;
    jpeg_component_info *c;
    if (setjmp(h->env)) return -1;
    if (ci < 0 || ci >= h->srcinfo.num_components) return -1;
    c = h->srcinfo.comp_info + ci;
    for (by = 0; by < c->height_in_blocks; by++) {
        JBLOCKARRAY rows = (*h->srcinfo.mem->access_virt_barray)
            ((j_common_ptr)&h->srcinfo, h->coef_arrays[ci], by, 1, FALSE);
        memcpy(out + (size_t)by * c->width_in_blocks * DCTSIZE2,
               rows[0], (size_t)c->width_in_blocks * DCTSIZE2 * sizeof(JCOEF));
    }
    return 0;
}

/* Write one component's coefficient blocks back into the virtual array. */
QS_EXPORT int qs_write_coefs(qs_handle *h, int ci, const int16_t *in) {
    JDIMENSION by;
    jpeg_component_info *c;
    if (setjmp(h->env)) return -1;
    if (ci < 0 || ci >= h->srcinfo.num_components) return -1;
    c = h->srcinfo.comp_info + ci;
    for (by = 0; by < c->height_in_blocks; by++) {
        JBLOCKARRAY rows = (*h->srcinfo.mem->access_virt_barray)
            ((j_common_ptr)&h->srcinfo, h->coef_arrays[ci], by, 1, TRUE);
        memcpy(rows[0], in + (size_t)by * c->width_in_blocks * DCTSIZE2,
               (size_t)c->width_in_blocks * DCTSIZE2 * sizeof(JCOEF));
    }
    return 0;
}

/* UPSAMPLE_UV: replace chroma components 1 and 2 with full-resolution
 * coefficient planes at the luma block dimensions and rewrite sampling
 * factors to 1x1 (reference: quantsmooth.h:2701-2703, 2836-2849). */
QS_EXPORT int qs_set_upsampled(qs_handle *h, const int16_t *cb, const int16_t *cr) {
    struct jpeg_decompress_struct *s = &h->srcinfo;
    jpeg_component_info *c = s->comp_info;
    JDIMENSION w, hgt, by;
    int ci;
    const int16_t *src[2];
    if (setjmp(h->env)) return -1;
    if (s->num_components < 3) return -1;
    w = c[0].width_in_blocks;
    hgt = c[0].height_in_blocks;
    src[0] = cb; src[1] = cr;
    for (ci = 1; ci <= 2; ci++) {
        h->coef_up[ci - 1] = (*s->mem->request_virt_barray)
            ((j_common_ptr)s, JPOOL_IMAGE, FALSE, w, hgt, 1);
    }
    (*s->mem->realize_virt_arrays)((j_common_ptr)s);
    for (ci = 1; ci <= 2; ci++) {
        for (by = 0; by < hgt; by++) {
            JBLOCKARRAY rows = (*s->mem->access_virt_barray)
                ((j_common_ptr)s, h->coef_up[ci - 1], by, 1, TRUE);
            memcpy(rows[0], src[ci - 1] + (size_t)by * w * DCTSIZE2,
                   (size_t)w * DCTSIZE2 * sizeof(JCOEF));
        }
        h->coef_arrays[ci] = h->coef_up[ci - 1];
        c[ci].width_in_blocks = w;
        c[ci].height_in_blocks = hgt;
    }
    s->max_h_samp_factor = 1;
    s->max_v_samp_factor = 1;
    c[0].h_samp_factor = 1;
    c[0].v_samp_factor = 1;
    h->upsampled = 1;
    return 0;
}

/* Re-encode: set all quant tables to 1 (reference: quantsmooth.h:2851-2859),
 * copy critical parameters, write coefficients and markers.
 * Returns malloc'd buffer via *out (caller frees with qs_free_buf). */
QS_EXPORT int qs_save(qs_handle *h, int optimize, int set_qtable_one,
                      uint8_t **out, size_t *out_size) {
    struct jpeg_compress_struct dstinfo;
    struct jpeg_error_mgr jdsterr;
    jpeg_saved_marker_ptr marker;
    int ci, i;
    JQUANT_TBL *qtbl;

    h->saved_mask = 0;
    h->save_buf = NULL;
    h->save_bufsize = 0;
    dstinfo.mem = NULL;

    if (setjmp(h->env)) {
        /* error mid-compress: restore the mutated source tables and
         * release the compressor + output buffer before failing */
        if (dstinfo.mem) jpeg_destroy_compress(&dstinfo);
        qs_restore_qtables(h);
        free(h->save_buf);
        h->save_buf = NULL;
        return -1;
    }

    if (set_qtable_one) {
        /* originals stashed (on the handle, longjmp-safe) so repeated
         * and failed saves see unmutated source tables */
        for (ci = 0; ci < NUM_QUANT_TBLS; ci++) {
            qtbl = h->srcinfo.quant_tbl_ptrs[ci];
            if (!qtbl) continue;
            memcpy(h->saved_q[ci], qtbl->quantval, sizeof(h->saved_q[ci]));
            h->saved_mask |= 1 << ci;
            for (i = 0; i < DCTSIZE2; i++) qtbl->quantval[i] = 1;
        }
        /* comp_info quant_table may be a private copy, not a
         * quant_tbl_ptrs alias — set (and restore) it independently */
        for (ci = 0; ci < h->srcinfo.num_components; ci++) {
            qtbl = h->srcinfo.comp_info[ci].quant_table;
            if (qtbl) for (i = 0; i < DCTSIZE2; i++) qtbl->quantval[i] = 1;
        }
    }

    dstinfo.err = jpeg_std_error(&jdsterr);
    jdsterr.error_exit = qs_error_exit;
    jdsterr.emit_message = qs_emit_message;
    jdsterr.trace_level = h->verbose;
    dstinfo.client_data = h;
    jpeg_create_compress(&dstinfo);
    jpeg_copy_critical_parameters(&h->srcinfo, &dstinfo);
    if (optimize) dstinfo.optimize_coding = TRUE;
    jpeg_mem_dest(&dstinfo, &h->save_buf, &h->save_bufsize);
    jpeg_write_coefficients(&dstinfo, h->coef_arrays);
    /* marker copy with JFIF/Adobe dedup: reference quantsmooth.c:581-590 */
    for (marker = h->srcinfo.marker_list; marker; marker = marker->next) {
        if (dstinfo.write_JFIF_header && marker->marker == JPEG_APP0 &&
            marker->data_length >= 5 && !memcmp(marker->data, "JFIF", 5)) continue;
        if (dstinfo.write_Adobe_marker && marker->marker == JPEG_APP0 + 14 &&
            marker->data_length >= 5 && !memcmp(marker->data, "Adobe", 5)) continue;
        jpeg_write_marker(&dstinfo, marker->marker, marker->data, marker->data_length);
    }
    jpeg_finish_compress(&dstinfo);
    h->extra_warnings += (int32_t)jdsterr.num_warnings;
    jpeg_destroy_compress(&dstinfo);
    qs_restore_qtables(h);
    *out = h->save_buf;
    *out_size = h->save_bufsize;
    h->save_buf = NULL;
    return 0;
}

/* Total libjpeg corrupt-data warnings so far (decode + any saves) —
 * the reference CLI's exit-code source (quantsmooth.c:626). */
QS_EXPORT int32_t qs_num_warnings(qs_handle *h) {
    return (int32_t)h->srcinfo.err->num_warnings + h->extra_warnings;
}

QS_EXPORT void qs_free_buf(uint8_t *buf) { free(buf); }

QS_EXPORT void qs_close(qs_handle *h) {
    if (!h) return;
    if (h->open_ok || h->srcinfo.mem) {
        if (!setjmp(h->env)) {
            jpeg_finish_decompress(&h->srcinfo);
        }
        if (!setjmp(h->env)) {
            jpeg_destroy_decompress(&h->srcinfo);
        }
    }
    free(h->input_copy);
    free(h);
}

/* ---------- corpus helpers (encode pixels, decode to pixels) ---------- */

typedef struct {
    struct jpeg_error_mgr jerr;
    jmp_buf env;
    char errmsg[JMSG_LENGTH_MAX];
} qs_simple_err;

static void qs_simple_error_exit(j_common_ptr cinfo) {
    qs_simple_err *e = (qs_simple_err *)cinfo->client_data;
    (*cinfo->err->format_message)(cinfo, e->errmsg);
    longjmp(e->env, 1);
}

/* Encode interleaved pixels (ncomp 1=gray, 3=RGB, 4=CMYK) to JPEG.
 * subsamp: 0 = 4:4:4, 1 = 4:2:0, 2 = 4:2:2, 3 = 4:4:0,
 *          4 = 4:1:1 (luma 4x1), 5 = luma 4x2 (exotic).
 * arith: arithmetic entropy coding (the reference reads/writes these
 * through the same libjpeg paths, quantsmooth.c:548-549, 579).
 * restart_interval: emit DRI/RSTn markers every N MCUs (0 = none). */
QS_EXPORT int qs_encode(const uint8_t *pixels, int w, int hgt, int ncomp,
                        int quality, int subsamp, int progressive,
                        int arith, int restart_interval,
                        uint8_t **out, size_t *out_size) {
    struct jpeg_compress_struct cinfo;
    qs_simple_err err;
    unsigned char *buffer = NULL;
    unsigned long bufsize = 0;
    int y;

    cinfo.err = jpeg_std_error(&err.jerr);
    err.jerr.error_exit = qs_simple_error_exit;
    cinfo.client_data = &err;
    if (setjmp(err.env)) { jpeg_destroy_compress(&cinfo); return -1; }
    jpeg_create_compress(&cinfo);
    jpeg_mem_dest(&cinfo, &buffer, &bufsize);
    cinfo.image_width = w;
    cinfo.image_height = hgt;
    cinfo.input_components = ncomp;
    cinfo.in_color_space = ncomp == 1 ? JCS_GRAYSCALE
                         : ncomp == 4 ? JCS_CMYK : JCS_RGB;
    jpeg_set_defaults(&cinfo);
    jpeg_set_quality(&cinfo, quality, TRUE);
    if (ncomp == 3) {
        if (subsamp == 0) {
            cinfo.comp_info[0].h_samp_factor = 1;
            cinfo.comp_info[0].v_samp_factor = 1;
        } else if (subsamp == 2) {
            cinfo.comp_info[0].h_samp_factor = 2;
            cinfo.comp_info[0].v_samp_factor = 1;
        } else if (subsamp == 3) {
            cinfo.comp_info[0].h_samp_factor = 1;
            cinfo.comp_info[0].v_samp_factor = 2;
        } else if (subsamp == 4) {
            cinfo.comp_info[0].h_samp_factor = 4;
            cinfo.comp_info[0].v_samp_factor = 1;
        } else if (subsamp == 5) {
            cinfo.comp_info[0].h_samp_factor = 4;
            cinfo.comp_info[0].v_samp_factor = 2;
        } /* default (1) is 2x2 = 4:2:0 */
    }
    if (progressive) jpeg_simple_progression(&cinfo);
    if (arith) cinfo.arith_code = TRUE;
    if (restart_interval > 0) cinfo.restart_interval = restart_interval;
    jpeg_start_compress(&cinfo, TRUE);
    for (y = 0; y < hgt; y++) {
        JSAMPROW row = (JSAMPROW)(pixels + (size_t)y * w * ncomp);
        jpeg_write_scanlines(&cinfo, &row, 1);
    }
    jpeg_finish_compress(&cinfo);
    jpeg_destroy_compress(&cinfo);
    *out = buffer;
    *out_size = bufsize;
    return 0;
}

/* Decode a JPEG to interleaved 8-bit pixels (RGB or grayscale). */
QS_EXPORT int qs_decode(const uint8_t *data, size_t size,
                        uint8_t **pixels, int32_t *w, int32_t *hgt, int32_t *ncomp) {
    struct jpeg_decompress_struct cinfo;
    qs_simple_err err;
    uint8_t *buf = NULL;
    cinfo.err = jpeg_std_error(&err.jerr);
    err.jerr.error_exit = qs_simple_error_exit;
    cinfo.client_data = &err;
    if (setjmp(err.env)) { free(buf); jpeg_destroy_decompress(&cinfo); return -1; }
    jpeg_create_decompress(&cinfo);
    jpeg_mem_src(&cinfo, data, (unsigned long)size);
    jpeg_read_header(&cinfo, TRUE);
    jpeg_start_decompress(&cinfo);
    *w = cinfo.output_width;
    *hgt = cinfo.output_height;
    *ncomp = cinfo.output_components;
    buf = (uint8_t *)malloc((size_t)cinfo.output_width * cinfo.output_height *
                            cinfo.output_components);
    if (!buf) { jpeg_destroy_decompress(&cinfo); return -1; }
    while (cinfo.output_scanline < cinfo.output_height) {
        JSAMPROW row = buf + (size_t)cinfo.output_scanline *
                       cinfo.output_width * cinfo.output_components;
        jpeg_read_scanlines(&cinfo, &row, 1);
    }
    jpeg_finish_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    *pixels = buf;
    return 0;
}
