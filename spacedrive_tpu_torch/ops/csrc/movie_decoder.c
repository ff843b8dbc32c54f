/* Native video decode frontend over FFmpeg (libavformat/-codec/-util +
 * libswscale).
 *
 * Role parity with the reference's sd-ffmpeg crate
 * (ref:crates/ffmpeg/src/movie_decoder.rs:32-629):
 *   - preferred video stream selection with embedded-cover-art
 *     preference (ref:movie_decoder.rs:352 — a stream with the
 *     ATTACHED_PIC disposition wins outright),
 *   - seek ~10% into the container before grabbing a frame,
 *   - rotation read from the stream display matrix and reported to the
 *     caller (the Python side rotates the RGBA array; same output as
 *     the reference's rotation-aware filter graph),
 *   - RGBA conversion through swscale.
 *
 * Exported C ABI (ctypes):
 *   int  sd_video_frame(path, seek_fraction, &buf, &w, &h,
 *                       &rotation_deg, &is_cover, errbuf, errlen);
 *   int  sd_video_meta(path, &duration_s, &fps, &w, &h, &nb_frames,
 *                      codec_buf, codec_len);
 *   void sd_video_free(buf);
 *
 * The port's owned copy of spacedrive_tpu/native/movie_decoder.c, built
 * at first use by spacedrive_tpu_torch/native/video.py.
 */

#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/display.h>
#include <libavutil/imgutils.h>
#include <libswscale/swscale.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

static void set_err(char *errbuf, int errlen, const char *msg, int averr) {
    if (!errbuf || errlen <= 0) return;
    if (averr) {
        char avmsg[128];
        av_strerror(averr, avmsg, sizeof(avmsg));
        snprintf(errbuf, errlen, "%s: %s", msg, avmsg);
    } else {
        snprintf(errbuf, errlen, "%s", msg);
    }
}

/* rotation in degrees [0, 360) from the stream's display matrix */
static int stream_rotation(const AVStream *st) {
    #if LIBAVFORMAT_VERSION_MAJOR >= 60
    const AVPacketSideData *sd = av_packet_side_data_get(
        st->codecpar->coded_side_data, st->codecpar->nb_coded_side_data,
        AV_PKT_DATA_DISPLAYMATRIX);
    const uint8_t *matrix = sd ? sd->data : NULL;
    #else
    const uint8_t *matrix =
        av_stream_get_side_data(st, AV_PKT_DATA_DISPLAYMATRIX, NULL);
    #endif
    if (!matrix) return 0;
    double theta = av_display_rotation_get((const int32_t *)matrix);
    if (isnan(theta)) return 0;
    int deg = (int)lround(-theta);  /* display matrix counters rotation */
    deg %= 360;
    if (deg < 0) deg += 360;
    return deg;
}

static int frame_to_rgba(const AVFrame *frame, uint8_t **out, int *w,
                         int *h, char *errbuf, int errlen) {
    struct SwsContext *sws = sws_getContext(
        frame->width, frame->height, (enum AVPixelFormat)frame->format,
        frame->width, frame->height, AV_PIX_FMT_RGBA,
        SWS_BILINEAR, NULL, NULL, NULL);
    if (!sws) {
        set_err(errbuf, errlen, "swscale context failed", 0);
        return -1;
    }
    /* swscale's vector loops write whole vectors: give it rows of a
     * 64-byte multiple and a spare tail, then pack the rows tight
     * (rows of width*4 bytes with no padding overrun the buffer for
     * widths whose row is not a multiple of the vector width, as in
     * spacedrive_tpu/native/movie_decoder.c) */
    int tight = frame->width * 4;
    int stride = FFALIGN(tight, 64);
    uint8_t *buf = av_malloc((size_t)stride * frame->height + 64);
    if (!buf) {
        sws_freeContext(sws);
        set_err(errbuf, errlen, "out of memory", 0);
        return -1;
    }
    uint8_t *dst[4] = {buf, NULL, NULL, NULL};
    int dst_stride[4] = {stride, 0, 0, 0};
    sws_scale(sws, (const uint8_t *const *)frame->data, frame->linesize, 0,
              frame->height, dst, dst_stride);
    sws_freeContext(sws);
    for (int y = 1; stride != tight && y < frame->height; y++)
        memmove(buf + (size_t)y * tight, buf + (size_t)y * stride, (size_t)tight);
    *out = buf;
    *w = frame->width;
    *h = frame->height;
    return 0;
}

/* decode one packet's worth of image (cover art path) or the first
 * decodable frame from the current position */
static int decode_one_frame(AVCodecContext *ctx, AVFormatContext *fmt,
                            int stream_index, const AVPacket *only_pkt,
                            AVFrame *frame, char *errbuf, int errlen) {
    int ret;
    if (only_pkt) {
        ret = avcodec_send_packet(ctx, only_pkt);
        if (ret < 0) {
            set_err(errbuf, errlen, "send cover packet", ret);
            return -1;
        }
        avcodec_send_packet(ctx, NULL); /* flush */
        ret = avcodec_receive_frame(ctx, frame);
        if (ret < 0) {
            set_err(errbuf, errlen, "decode cover", ret);
            return -1;
        }
        return 0;
    }
    AVPacket *pkt = av_packet_alloc();
    if (!pkt) return -1;
    int tries = 2048; /* bounded walk to the next decodable frame */
    while (tries-- > 0) {
        ret = av_read_frame(fmt, pkt);
        if (ret < 0) {
            avcodec_send_packet(ctx, NULL);
            if (avcodec_receive_frame(ctx, frame) == 0) {
                av_packet_free(&pkt);
                return 0;
            }
            set_err(errbuf, errlen, "no decodable frame", ret);
            av_packet_free(&pkt);
            return -1;
        }
        if (pkt->stream_index == stream_index) {
            ret = avcodec_send_packet(ctx, pkt);
            av_packet_unref(pkt);
            if (ret < 0 && ret != AVERROR(EAGAIN)) {
                set_err(errbuf, errlen, "send packet", ret);
                av_packet_free(&pkt);
                return -1;
            }
            ret = avcodec_receive_frame(ctx, frame);
            if (ret == 0) {
                av_packet_free(&pkt);
                return 0;
            }
            if (ret != AVERROR(EAGAIN)) {
                set_err(errbuf, errlen, "receive frame", ret);
                av_packet_free(&pkt);
                return -1;
            }
        } else {
            av_packet_unref(pkt);
        }
    }
    av_packet_free(&pkt);
    set_err(errbuf, errlen, "frame walk budget exhausted", 0);
    return -1;
}

int sd_video_frame(const char *path, double seek_fraction, uint8_t **out,
                   int *out_w, int *out_h, int *out_rotation,
                   int *out_is_cover, char *errbuf, int errlen) {
    AVFormatContext *fmt = NULL;
    AVCodecContext *ctx = NULL;
    AVFrame *frame = NULL;
    int ret, rc = -1;

    ret = avformat_open_input(&fmt, path, NULL, NULL);
    if (ret < 0) {
        set_err(errbuf, errlen, "open", ret);
        return -1;
    }
    ret = avformat_find_stream_info(fmt, NULL);
    if (ret < 0) {
        set_err(errbuf, errlen, "stream info", ret);
        goto done;
    }

    /* embedded cover art wins outright (ref:movie_decoder.rs:352) */
    int stream_index = -1, is_cover = 0;
    for (unsigned i = 0; i < fmt->nb_streams; i++) {
        AVStream *st = fmt->streams[i];
        if (st->codecpar->codec_type == AVMEDIA_TYPE_VIDEO &&
            (st->disposition & AV_DISPOSITION_ATTACHED_PIC) &&
            st->attached_pic.size > 0) {
            stream_index = (int)i;
            is_cover = 1;
            break;
        }
    }
    if (stream_index < 0) {
        stream_index =
            av_find_best_stream(fmt, AVMEDIA_TYPE_VIDEO, -1, -1, NULL, 0);
        if (stream_index < 0) {
            set_err(errbuf, errlen, "no video stream", stream_index);
            goto done;
        }
    }
    AVStream *st = fmt->streams[stream_index];

    const AVCodec *codec = avcodec_find_decoder(st->codecpar->codec_id);
    if (!codec) {
        set_err(errbuf, errlen, "no decoder for codec", 0);
        goto done;
    }
    ctx = avcodec_alloc_context3(codec);
    if (!ctx) goto done;
    ret = avcodec_parameters_to_context(ctx, st->codecpar);
    if (ret < 0) {
        set_err(errbuf, errlen, "codec params", ret);
        goto done;
    }
    ret = avcodec_open2(ctx, codec, NULL);
    if (ret < 0) {
        set_err(errbuf, errlen, "open codec", ret);
        goto done;
    }

    if (!is_cover && fmt->duration > 0 && seek_fraction > 0) {
        int64_t ts = (int64_t)(fmt->duration * seek_fraction);
        /* offset containers (MPEG-TS captures) start at nonzero pts */
        if (fmt->start_time != AV_NOPTS_VALUE && fmt->start_time > 0)
            ts += fmt->start_time;
        /* seek on the default timebase; fall back to start on failure
         * (ref:movie_decoder.rs seeks then decodes forward) */
        if (av_seek_frame(fmt, -1, ts, AVSEEK_FLAG_BACKWARD) < 0)
            av_seek_frame(fmt, -1, 0, AVSEEK_FLAG_BACKWARD);
        avcodec_flush_buffers(ctx);
    }

    frame = av_frame_alloc();
    if (!frame) goto done;
    ret = decode_one_frame(ctx, fmt, stream_index,
                           is_cover ? &st->attached_pic : NULL, frame,
                           errbuf, errlen);
    if (ret < 0) goto done;

    if (frame_to_rgba(frame, out, out_w, out_h, errbuf, errlen) < 0)
        goto done;
    *out_rotation = stream_rotation(st);
    *out_is_cover = is_cover;
    rc = 0;

done:
    if (frame) av_frame_free(&frame);
    if (ctx) avcodec_free_context(&ctx);
    if (fmt) avformat_close_input(&fmt);
    return rc;
}

int sd_video_meta(const char *path, double *duration_s, double *fps,
                  int *w, int *h, int64_t *nb_frames, char *codec_buf,
                  int codec_len) {
    AVFormatContext *fmt = NULL;
    if (avformat_open_input(&fmt, path, NULL, NULL) < 0) return -1;
    if (avformat_find_stream_info(fmt, NULL) < 0) {
        avformat_close_input(&fmt);
        return -1;
    }
    int si = av_find_best_stream(fmt, AVMEDIA_TYPE_VIDEO, -1, -1, NULL, 0);
    if (si < 0) {
        avformat_close_input(&fmt);
        return -1;
    }
    AVStream *st = fmt->streams[si];
    *duration_s = fmt->duration > 0 ? fmt->duration / (double)AV_TIME_BASE
                                    : 0.0;
    AVRational fr = st->avg_frame_rate.num ? st->avg_frame_rate
                                           : st->r_frame_rate;
    *fps = fr.den ? fr.num / (double)fr.den : 0.0;
    *w = st->codecpar->width;
    *h = st->codecpar->height;
    *nb_frames = st->nb_frames;
    if (*nb_frames == 0 && *fps > 0 && *duration_s > 0)
        *nb_frames = (int64_t)llround(*duration_s * *fps);
    const char *name = avcodec_get_name(st->codecpar->codec_id);
    snprintf(codec_buf, codec_len, "%s", name ? name : "unknown");
    avformat_close_input(&fmt);
    return 0;
}

void sd_video_free(uint8_t *buf) { av_free(buf); }
