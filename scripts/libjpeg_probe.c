/* Decodes one JPEG with the system's libjpeg from a whole buffer, as the
 * JAX package's native extension does (jpeg_mem_src, out_color_space RGB),
 * and prints each warning libjpeg emits: what the port's libjpeg mode
 * (latent2im_tpu_torch/utils/jpeg.py, libjpeg=True) is held to on corrupt
 * data.
 *
 *   gcc -O2 -o build/libjpeg_probe scripts/libjpeg_probe.c -ljpeg
 *   build/libjpeg_probe in.jpg out.rgb [do_block_smoothing]
 *
 * Prints "OK height width" then the warnings' message codes (jerror.h:
 * JWRN_EXTRANEOUS_DATA, JWRN_HIT_MARKER, JWRN_HUFF_BAD_CODE,
 * JWRN_MUST_RESYNC, JWRN_NOT_SEQUENTIAL, ...) and writes the RGB bytes to
 * out.rgb; or "ERR code message" where libjpeg fails the file. Each
 * warning's text goes to stderr. */
#include <setjmp.h>
#include <stddef.h>
#include <stdio.h>
#include <stdlib.h>
/* jpeglib.h wants size_t and FILE first */
#include <jpeglib.h>
#include <jerror.h>

struct err_mgr {
  struct jpeg_error_mgr pub;
  jmp_buf jb;
};

static int n_warn = 0;
static int warn_codes[64];

static void on_error(j_common_ptr c) {
  char msg[JMSG_LENGTH_MAX];
  c->err->format_message(c, msg);
  printf("ERR %d %s\n", c->err->msg_code, msg);
  longjmp(((struct err_mgr*)c->err)->jb, 1);
}

static void on_message(j_common_ptr c, int level) {
  if (level >= 0) return;  /* trace messages */
  char msg[JMSG_LENGTH_MAX];
  c->err->format_message(c, msg);
  if (n_warn < 64) warn_codes[n_warn] = c->err->msg_code;
  n_warn++;
  fprintf(stderr, "W %d %s\n", c->err->msg_code, msg);
}

int main(int argc, char** argv) {
  if (argc < 3) {
    fprintf(stderr, "usage: %s in.jpg out.rgb [do_block_smoothing]\n", argv[0]);
    return 2;
  }
  FILE* f = fopen(argv[1], "rb");
  if (!f) return 2;
  fseek(f, 0, SEEK_END);
  long n = ftell(f);
  fseek(f, 0, SEEK_SET);
  unsigned char* buf = malloc(n);
  if (fread(buf, 1, n, f) != (size_t)n) return 2;
  fclose(f);
  struct jpeg_decompress_struct ci;
  struct err_mgr e;
  ci.err = jpeg_std_error(&e.pub);
  e.pub.error_exit = on_error;
  e.pub.emit_message = on_message;
  if (setjmp(e.jb)) {
    jpeg_destroy_decompress(&ci);
    return 1;
  }
  jpeg_create_decompress(&ci);
  jpeg_mem_src(&ci, buf, n);
  jpeg_read_header(&ci, TRUE);
  ci.out_color_space = JCS_RGB;
  if (argc > 3) ci.do_block_smoothing = atoi(argv[3]);
  jpeg_start_decompress(&ci);
  int w = ci.output_width, h = ci.output_height;
  unsigned char* out = malloc((size_t)w * h * 3);
  while (ci.output_scanline < ci.output_height) {
    unsigned char* row = out + (size_t)ci.output_scanline * w * 3;
    jpeg_read_scanlines(&ci, &row, 1);
  }
  jpeg_finish_decompress(&ci);
  jpeg_destroy_decompress(&ci);
  FILE* o = fopen(argv[2], "wb");
  fwrite(out, 1, (size_t)w * h * 3, o);
  fclose(o);
  printf("OK %d %d", h, w);
  for (int i = 0; i < n_warn && i < 64; i++) printf(" %d", warn_codes[i]);
  printf("\n");
  return 0;
}
