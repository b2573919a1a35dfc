/*
 * Oracle test-vector generator.
 *
 * Drives the REFERENCE clownresampler implementation (read-only mount at
 * /root/reference/clownresampler.h) across a wide grid of configurations and
 * dumps inputs/outputs/state as flat binary files plus a JSON manifest.
 * `tools/pack_vectors.py` packs the directory into tests/fixtures/oracle_vectors.npz.
 *
 * This file contains only harness code (no library code); it exists so the
 * committed vector archive can be regenerated and audited. Build:
 *   gcc -O2 -I/root/reference tools/gen_oracle_vectors.c -o gen_vectors -lm
 *   ./gen_vectors <output_dir>
 *
 * Coverage (gaps called out in SURVEY.md section 4 included):
 *   - kernel LUT dump (clownresampler.h:955-961)
 *   - LowestLevel_Configure derived parameters + CalculateRatio (913-984)
 *   - LowestLevel_Resample single frames across ratios/phases/channels (986-1035)
 *   - LowLevel_Resample streaming: chunked feeds, position carry (1063-1068),
 *     output-full rewind (1084-1088), mid-stream Adjust / pitch bend (1052-1056)
 *   - HighLevel_Resample / Adjust / ResampleEnd buffered streaming (1096-1252)
 */

#define CLOWNRESAMPLER_IMPLEMENTATION
#define CLOWNRESAMPLER_STATIC
#include "clownresampler.h"

#include <stdio.h>
#include <stdlib.h>
#include <string.h>

static FILE *manifest;
static const char *outdir;

/* Deterministic PRNG (xorshift32) so vectors are reproducible. */
static unsigned int rng_state = 0x12345678u;
static unsigned int rng_next(void)
{
    unsigned int x = rng_state;
    x ^= x << 13; x ^= x >> 17; x ^= x << 5;
    rng_state = x;
    return x;
}
static cc_s16l rng_sample(void)
{
    /* Full-range 16-bit samples, including extremes. */
    return (cc_s16l)(short)(rng_next() & 0xFFFFu);
}

static FILE *open_bin(const char *name)
{
    char path[1024];
    FILE *f;
    sprintf(path, "%s/%s.bin", outdir, name);
    f = fopen(path, "wb");
    if (f == NULL) { fprintf(stderr, "cannot open %s\n", path); exit(1); }
    return f;
}

static void write_i64(FILE *f, long long v) { fwrite(&v, 8, 1, f); }
static void write_i16(FILE *f, short v)     { fwrite(&v, 2, 1, f); }
static void write_i32(FILE *f, int v)       { fwrite(&v, 4, 1, f); }

/* ------------------------------------------------------------------ */
/* Group A: kernel LUT                                                  */
/* ------------------------------------------------------------------ */
static void dump_table(const ClownResampler_Precomputed *pre)
{
    FILE *f = open_bin("kernel_table");
    size_t i;
    for (i = 0; i < CLOWNRESAMPLER_COUNT_OF(pre->lanczos_kernel_table); ++i)
        write_i32(f, (int)pre->lanczos_kernel_table[i]);
    fclose(f);
    fprintf(manifest, "  \"kernel_table\": {\"file\": \"kernel_table.bin\", \"dtype\": \"i32\", \"count\": %d},\n",
            (int)CLOWNRESAMPLER_COUNT_OF(pre->lanczos_kernel_table));
}

/* ------------------------------------------------------------------ */
/* Group B: configure + ratio                                           */
/* ------------------------------------------------------------------ */
static const cc_u32f config_triples[][3] = {
    {8000, 44100, 44100}, {8000, 44100, 8000},
    {44100, 8000, 44100}, {44100, 8000, 8000},
    {48000, 44100, 44100}, {44100, 48000, 48000},
    {96000, 48000, 96000}, {48000, 96000, 96000},
    {1, 2, 2}, {2, 1, 2}, {3, 1, 3}, {1, 3, 3},
    {44100, 44100, 44100}, {22050, 44100, 44100},
    {48000, 8000, 48000}, {8000, 48000, 48000},
    {7, 13, 13}, {13, 7, 13},
    {48000, 44100, 22050},  /* lpf below both rates */
    {40000, 997, 40000},    /* extreme downsample, ~40x */
    {192000, 44100, 44100},
    {44100, 192000, 192000},
    {65521, 65537, 65537},  /* near-unity prime rates */
    {44100, 132, 44100},    /* wide kernel: scale ~334, radius 1003 */
    {44100, 12, 44100},     /* near the scale<0x1000 cap: radius 11025 */
    {0, 44100, 44100},      /* zero rate -> sentinel ratio */
    {44100, 0, 44100},
    {300000000, 44100, 44100}, /* scale over 0x1000 -> Configure fails */
};

static void dump_configs(void)
{
    FILE *f = open_bin("configs");
    size_t i;
    for (i = 0; i < CLOWNRESAMPLER_COUNT_OF(config_triples); ++i)
    {
        const cc_u32f in = config_triples[i][0], out = config_triples[i][1], lpf = config_triples[i][2];
        ClownResampler_LowestLevel_Configuration cfg;
        cc_bool ok;
        memset(&cfg, 0, sizeof(cfg));
        ok = ClownResampler_LowestLevel_Configure(&cfg, in, out, lpf);
        write_i64(f, (long long)in);
        write_i64(f, (long long)out);
        write_i64(f, (long long)lpf);
        write_i64(f, (long long)ok);
        write_i64(f, (long long)cfg.stretched_kernel_radius);
        write_i64(f, (long long)cfg.integer_stretched_kernel_radius);
        write_i64(f, (long long)cfg.stretched_kernel_radius_delta);
        write_i64(f, (long long)cfg.kernel_step_size);
        write_i64(f, (long long)ClownResampler_CalculateRatio(in, out));
        write_i64(f, (long long)ClownResampler_CalculateRatio(out, in));
    }
    fclose(f);
    fprintf(manifest, "  \"configs\": {\"file\": \"configs.bin\", \"dtype\": \"i64\", \"rows\": %d, \"cols\": 10},\n",
            (int)CLOWNRESAMPLER_COUNT_OF(config_triples));
}

/* ------------------------------------------------------------------ */
/* Group C: lowest-level single-frame convolution                       */
/* ------------------------------------------------------------------ */
static void dump_lowest_level(const ClownResampler_Precomputed *pre)
{
    /* meta rows: in,out,lpf,channels,L_frames,pos_int,pos_frac (i64 x 7)
       input samples and outputs appended to shared streams */
    FILE *fmeta = open_bin("lowest_meta");
    FILE *fin = open_bin("lowest_input");
    FILE *fout = open_bin("lowest_output");
    int n_cases = 0;
    size_t t;

    static const cc_u32f trip[][3] = {
        {8000, 44100, 44100}, {44100, 8000, 44100}, {48000, 44100, 44100},
        {96000, 48000, 96000}, {48000, 44100, 22050}, {7, 13, 13}, {13, 7, 13},
        {44100, 44100, 44100}, {40000, 997, 40000},
        {44100, 132, 44100},  /* wide kernel, radius 1003 (full ratio domain) */
    };
    static const cc_u8f chans[] = {1, 2, 4, 16};

    for (t = 0; t < CLOWNRESAMPLER_COUNT_OF(trip); ++t)
    {
        ClownResampler_LowestLevel_Configuration cfg;
        size_t c;
        if (!ClownResampler_LowestLevel_Configure(&cfg, trip[t][0], trip[t][1], trip[t][2]))
            continue;
        for (c = 0; c < CLOWNRESAMPLER_COUNT_OF(chans); ++c)
        {
            const cc_u8f ch = chans[c];
            const size_t L = 8; /* logical frames */
            const size_t total = L + 2 * cfg.integer_stretched_kernel_radius + 2;
            cc_s16l *input = (cc_s16l *)malloc(total * ch * sizeof(cc_s16l));
            size_t i, p;
            static const cc_u32f fracs[] = {0, 1, 0x8000, 0xFFFF, 0x3A5C, 0xC001};

            for (i = 0; i < total * ch; ++i)
                input[i] = rng_sample();

            for (p = 0; p < L; p += 3)
            {
                size_t fi;
                for (fi = 0; fi < CLOWNRESAMPLER_COUNT_OF(fracs); ++fi)
                {
                    cc_s32f frame[CLOWNRESAMPLER_MAXIMUM_CHANNELS] = {0};
                    cc_u8f k;
                    ClownResampler_LowestLevel_Resample(&cfg, pre, frame, ch, input, p, fracs[fi]);
                    write_i64(fmeta, (long long)trip[t][0]);
                    write_i64(fmeta, (long long)trip[t][1]);
                    write_i64(fmeta, (long long)trip[t][2]);
                    write_i64(fmeta, (long long)ch);
                    write_i64(fmeta, (long long)total);
                    write_i64(fmeta, (long long)p);
                    write_i64(fmeta, (long long)fracs[fi]);
                    for (i = 0; i < total * ch; ++i)
                        write_i16(fin, (short)input[i]);
                    for (k = 0; k < ch; ++k)
                        write_i64(fout, (long long)frame[k]);
                    ++n_cases;
                }
            }
            free(input);
        }
    }
    fclose(fmeta); fclose(fin); fclose(fout);
    fprintf(manifest, "  \"lowest\": {\"meta\": \"lowest_meta.bin\", \"input\": \"lowest_input.bin\", \"output\": \"lowest_output.bin\", \"cases\": %d, \"meta_cols\": 7},\n", n_cases);
}

/* ------------------------------------------------------------------ */
/* Low-level streaming harness                                         */
/* ------------------------------------------------------------------ */
typedef struct OutSink
{
    FILE *f;
    long long produced;      /* total frames written this call */
    long long quota;         /* max frames this call, then refuse */
} OutSink;

static cc_bool sink_callback(void *ud, const cc_s32f *frame, cc_u8f total_samples)
{
    OutSink *s = (OutSink *)ud;
    cc_u8f i;
    for (i = 0; i < total_samples; ++i)
        write_i64(s->f, (long long)frame[i]);
    s->produced += 1;
    return s->produced < s->quota ? cc_true : cc_false;
}

/*
 * Script ops (all i64 in the ops file):
 *   op=1 FEED   n_frames quota   -> feed next n frames of the stream, output quota per call
 *   op=2 ADJUST in out lpf       -> LowLevel_Adjust
 * After every op we append a state/bookkeeping row:
 *   [op, arg0, arg1, arg2, ret, remaining_input, produced,
 *    position_integer, position_fractional, increment,
 *    stretched, int_radius, delta, step]
 */
static void run_lowlevel_script(const ClownResampler_Precomputed *pre,
                                const char *name, cc_u8f channels,
                                cc_u32f in_rate, cc_u32f out_rate, cc_u32f lpf,
                                const long long *ops, size_t n_ops,
                                size_t stream_frames, size_t max_radius_pad)
{
    char buf[64];
    FILE *fops, *fout, *fstream;
    ClownResampler_LowLevel_State st;
    cc_s16l *stream;
    size_t i, cursor = 0, op_i;
    OutSink sink;

    sprintf(buf, "%s_ops", name); fops = open_bin(buf);
    sprintf(buf, "%s_out", name); fout = open_bin(buf);
    sprintf(buf, "%s_stream", name); fstream = open_bin(buf);

    /* Stream with max_radius_pad zero frames on each side (external padding
       contract, clownresampler.h:725-733). */
    stream = (cc_s16l *)calloc((stream_frames + 2 * max_radius_pad) * channels, sizeof(cc_s16l));
    for (i = 0; i < stream_frames * channels; ++i)
        stream[max_radius_pad * channels + i] = rng_sample();
    for (i = 0; i < (stream_frames + 2 * max_radius_pad) * channels; ++i)
        write_i16(fstream, (short)stream[i]);

    if (!ClownResampler_LowLevel_Init(&st, channels, in_rate, out_rate, lpf))
    { fprintf(stderr, "init failed for %s\n", name); exit(1); }

    sink.f = fout;

    for (op_i = 0; op_i < n_ops; ++op_i)
    {
        const long long op = ops[op_i * 4 + 0];
        const long long a0 = ops[op_i * 4 + 1];
        const long long a1 = ops[op_i * 4 + 2];
        const long long a2 = ops[op_i * 4 + 3];
        long long ret = 0, remaining = 0;

        sink.produced = 0;
        sink.quota = 0;

        if (op == 1)
        {
            size_t n = (size_t)a0;
            size_t input_frames;
            if (n > stream_frames - cursor)
                n = stream_frames - cursor; /* clamp feed to remaining stream */
            input_frames = n;
            /* Buffer starts radius-before the chunk; chunk data plus trailing halo
               is available because the whole stream is materialized. */
            const cc_s16l *p = stream + (max_radius_pad + cursor - st.lowest_level.integer_stretched_kernel_radius) * channels;
            sink.quota = a1;
            ret = ClownResampler_LowLevel_Resample(&st, pre, p, &input_frames, sink_callback, &sink);
            remaining = (long long)input_frames;
            cursor += n - input_frames;
        }
        else if (op == 2)
        {
            ret = ClownResampler_LowLevel_Adjust(&st, (cc_u32f)a0, (cc_u32f)a1, (cc_u32f)a2);
        }

        write_i64(fops, op); write_i64(fops, a0); write_i64(fops, a1); write_i64(fops, a2);
        write_i64(fops, ret); write_i64(fops, remaining); write_i64(fops, sink.produced);
        write_i64(fops, (long long)st.position_integer);
        write_i64(fops, (long long)st.position_fractional);
        write_i64(fops, (long long)st.increment);
        write_i64(fops, (long long)st.lowest_level.stretched_kernel_radius);
        write_i64(fops, (long long)st.lowest_level.integer_stretched_kernel_radius);
        write_i64(fops, (long long)st.lowest_level.stretched_kernel_radius_delta);
        write_i64(fops, (long long)st.lowest_level.kernel_step_size);
    }

    free(stream);
    fclose(fops); fclose(fout); fclose(fstream);
    fprintf(manifest, "  \"%s\": {\"kind\": \"lowlevel\", \"channels\": %d, \"rates\": [%llu, %llu, %llu], \"ops\": %d, \"op_cols\": 14, \"stream_frames\": %d, \"pad\": %d},\n",
            name, (int)channels, (unsigned long long)in_rate, (unsigned long long)out_rate,
            (unsigned long long)lpf, (int)n_ops, (int)stream_frames, (int)max_radius_pad);
}

/* ------------------------------------------------------------------ */
/* High-level streaming harness                                        */
/* ------------------------------------------------------------------ */
typedef struct HLInput
{
    const cc_s16l *stream;
    size_t cursor;        /* frames */
    size_t channels;
    const long long *chunk_sizes;  /* scripted per-callback supply caps */
    size_t n_chunks, chunk_i;
    size_t stream_frames;
} HLInput;

/* HighLevel_Resample passes ONE user_data pointer to both callbacks
   (clownresampler.h:1120), so bundle input + sink. */
typedef struct HLContext
{
    HLInput input;
    OutSink sink;
} HLContext;

static size_t hl_input_callback(void *ud, cc_s16l *buffer, size_t total_frames)
{
    HLInput *in = &((HLContext *)ud)->input;
    size_t want = total_frames, give;
    if (in->chunk_i < in->n_chunks)
    {
        const size_t cap = (size_t)in->chunk_sizes[in->chunk_i++];
        if (cap < want) want = cap;
    }
    give = in->stream_frames - in->cursor;
    if (give > want) give = want;
    memcpy(buffer, in->stream + in->cursor * in->channels, give * in->channels * sizeof(cc_s16l));
    in->cursor += give;
    return give;
}

static cc_bool hl_sink_callback(void *ud, const cc_s32f *frame, cc_u8f total_samples)
{
    return sink_callback(&((HLContext *)ud)->sink, frame, total_samples);
}

/*
 * Script ops:
 *   op=1 RESAMPLE quota    -> HighLevel_Resample with output quota
 *   op=2 ADJUST in out lpf
 *   op=3 END quota         -> HighLevel_ResampleEnd with output quota
 * State row: [op,a0,a1,a2,ret,produced,input_cursor,
 *             position_integer,position_fractional,increment,int_radius,
 *             leading_padding_needed,trailing_padding_remaining,buffer_fill_frames]
 */
static void run_highlevel_script(const ClownResampler_Precomputed *pre,
                                 const char *name, cc_u8f channels,
                                 cc_u32f in_rate, cc_u32f out_rate, cc_u32f lpf,
                                 const long long *ops, size_t n_ops,
                                 const long long *chunks, size_t n_chunks,
                                 size_t stream_frames)
{
    char buf[64];
    FILE *fops, *fout, *fstream;
    ClownResampler_HighLevel_State st;
    cc_s16l *stream;
    size_t i, op_i;
    HLContext ctx;

    sprintf(buf, "%s_ops", name); fops = open_bin(buf);
    sprintf(buf, "%s_out", name); fout = open_bin(buf);
    sprintf(buf, "%s_stream", name); fstream = open_bin(buf);

    stream = (cc_s16l *)malloc(stream_frames * channels * sizeof(cc_s16l));
    for (i = 0; i < stream_frames * channels; ++i)
        stream[i] = rng_sample();
    for (i = 0; i < stream_frames * channels; ++i)
        write_i16(fstream, (short)stream[i]);

    if (!ClownResampler_HighLevel_Init(&st, channels, in_rate, out_rate, lpf))
    { fprintf(stderr, "hl init failed for %s\n", name); exit(1); }

    ctx.input.stream = stream; ctx.input.cursor = 0; ctx.input.channels = channels;
    ctx.input.chunk_sizes = chunks; ctx.input.n_chunks = n_chunks; ctx.input.chunk_i = 0;
    ctx.input.stream_frames = stream_frames;
    ctx.sink.f = fout;

    for (op_i = 0; op_i < n_ops; ++op_i)
    {
        const long long op = ops[op_i * 4 + 0];
        const long long a0 = ops[op_i * 4 + 1];
        const long long a1 = ops[op_i * 4 + 2];
        const long long a2 = ops[op_i * 4 + 3];
        long long ret = 0;

        ctx.sink.produced = 0;
        ctx.sink.quota = 0;

        if (op == 1)
        {
            ctx.sink.quota = a0;
            ret = ClownResampler_HighLevel_Resample(&st, pre, hl_input_callback, hl_sink_callback, &ctx);
        }
        else if (op == 2)
        {
            ret = ClownResampler_HighLevel_Adjust(&st, (cc_u32f)a0, (cc_u32f)a1, (cc_u32f)a2);
        }
        else if (op == 3)
        {
            ctx.sink.quota = a0;
            ret = ClownResampler_HighLevel_ResampleEnd(&st, pre, hl_sink_callback, &ctx);
        }

        write_i64(fops, op); write_i64(fops, a0); write_i64(fops, a1); write_i64(fops, a2);
        write_i64(fops, ret); write_i64(fops, ctx.sink.produced);
        write_i64(fops, (long long)ctx.input.cursor);
        write_i64(fops, (long long)st.low_level.position_integer);
        write_i64(fops, (long long)st.low_level.position_fractional);
        write_i64(fops, (long long)st.low_level.increment);
        write_i64(fops, (long long)st.low_level.lowest_level.integer_stretched_kernel_radius);
        write_i64(fops, (long long)st.leading_padding_frames_needed);
        write_i64(fops, (long long)st.trailing_padding_frames_remaining);
        write_i64(fops, (long long)((st.input_buffer_end - st.input_buffer_start) / st.low_level.channels));
    }

    free(stream);
    fclose(fops); fclose(fout); fclose(fstream);
    fprintf(manifest, "  \"%s\": {\"kind\": \"highlevel\", \"channels\": %d, \"rates\": [%llu, %llu, %llu], \"ops\": %d, \"op_cols\": 14, \"stream_frames\": %d},\n",
            name, (int)channels, (unsigned long long)in_rate, (unsigned long long)out_rate,
            (unsigned long long)lpf, (int)n_ops, (int)stream_frames);
}

int main(int argc, char **argv)
{
    static ClownResampler_Precomputed pre;
    char path[1024];

    if (argc < 2) { fprintf(stderr, "usage: %s <outdir>\n", argv[0]); return 1; }
    outdir = argv[1];

    sprintf(path, "%s/manifest.json", outdir);
    manifest = fopen(path, "w");
    if (manifest == NULL) { fprintf(stderr, "cannot open manifest\n"); return 1; }
    fprintf(manifest, "{\n");

    ClownResampler_Precompute(&pre);

    dump_table(&pre);
    dump_configs();
    dump_lowest_level(&pre);

    /* ---- low-level scripts ---- */
    {
        /* D1: one-shot whole buffer, unlimited output (like tests/test-low-level.c). */
        static const long long ops[] = { 1, 500, 1000000, 0 };
        run_lowlevel_script(&pre, "ll_oneshot_up", 2, 8000, 44100, 44100, ops, 1, 500, 17);
        run_lowlevel_script(&pre, "ll_oneshot_down", 2, 44100, 8000, 44100, ops, 1, 500, 17);
    }
    {
        /* D2: chunked feeds, odd sizes, unlimited output; tests position carry. */
        static const long long ops[] = {
            1, 7, 1000000, 0,
            1, 64, 1000000, 0,
            1, 13, 1000000, 0,
            1, 200, 1000000, 0,
            1, 1, 1000000, 0,
            1, 215, 1000000, 0,
        };
        run_lowlevel_script(&pre, "ll_chunked_up", 2, 8000, 44100, 44100, ops, 6, 500, 17);
        run_lowlevel_script(&pre, "ll_chunked_down", 2, 44100, 8000, 44100, ops, 6, 500, 17);
        run_lowlevel_script(&pre, "ll_chunked_mono", 1, 48000, 44100, 44100, ops, 6, 500, 17);
    }
    {
        /* D3: output-full rewind — tiny quotas against one big buffer. */
        static const long long ops[] = {
            1, 400, 5, 0,
            1, 400, 5, 0,
            1, 400, 3, 0,
            1, 400, 1, 0,
            1, 400, 7, 0,
            1, 400, 1000000, 0,
        };
        run_lowlevel_script(&pre, "ll_outfull_up", 2, 8000, 44100, 44100, ops, 6, 400, 17);
        run_lowlevel_script(&pre, "ll_outfull_down", 2, 44100, 8000, 44100, ops, 6, 400, 17);
    }
    {
        /* D4: pitch bend 0.5x -> 2.0x via Adjust between chunks. */
        static const long long ops[] = {
            1, 100, 1000000, 0,
            2, 22050, 44100, 44100,
            1, 100, 1000000, 0,
            2, 33075, 44100, 44100,
            1, 100, 1000000, 0,
            2, 44100, 44100, 44100,
            1, 100, 1000000, 0,
            2, 66150, 44100, 44100,
            1, 100, 1000000, 0,
            2, 88200, 44100, 44100,
            1, 100, 1000000, 0,
        };
        run_lowlevel_script(&pre, "ll_pitchbend", 2, 22050, 44100, 44100, ops, 11, 600, 17);
    }
    {
        /* D5: integer-ratio fast paths. */
        static const long long ops[] = { 1, 300, 1000000, 0 };
        run_lowlevel_script(&pre, "ll_int_up", 1, 1, 2, 2, ops, 1, 300, 17);
        run_lowlevel_script(&pre, "ll_int_down", 1, 2, 1, 2, ops, 1, 300, 17);
        run_lowlevel_script(&pre, "ll_unity", 2, 44100, 44100, 44100, ops, 1, 300, 17);
    }
    {
        /* D6: wide-kernel ratio domain. Configure accepts any kernel_scale
           < 0x1000 (clownresampler.h:974-975), but scales above the kernel
           RESOLUTION floor kernel_step_size to 0 and the normaliser division
           (line 1025) SIGFPEs on the first frame — 44100->44 (scale ~1002,
           radius 3007) is the widest ratio the reference can actually run;
           44100->43 and below crash. These pin radius 1003 and the de facto
           maximum 3007. */
        static const long long ops_wide[] = { 1, 4000, 1000000, 0 };
        static const long long ops_ultra[] = { 1, 12000, 1000000, 0 };
        run_lowlevel_script(&pre, "ll_wide", 2, 44100, 132, 44100, ops_wide, 1, 4000, 1003);
        run_lowlevel_script(&pre, "ll_ultrawide", 1, 44100, 44, 44100, ops_ultra, 1, 12000, 3007);
    }

    /* ---- high-level scripts ---- */
    {
        /* E1: scripted small input chunks + big output quota, then flush. */
        static const long long ops[] = {
            1, 100000, 0, 0,
            3, 100000, 0, 0,
        };
        static const long long chunks[] = { 100, 50, 1000, 3, 997, 10000, 10000 };
        run_highlevel_script(&pre, "hl_stream_up", 2, 8000, 44100, 44100, ops, 2, chunks, 7, 2000);
        run_highlevel_script(&pre, "hl_stream_down", 2, 44100, 8000, 44100, ops, 2, chunks, 7, 2000);
        run_highlevel_script(&pre, "hl_stream_mono", 1, 48000, 44100, 44100, ops, 2, chunks, 7, 2000);
    }
    {
        /* E2: output-quota-limited resumption. */
        static const long long ops[] = {
            1, 50, 0, 0,
            1, 50, 0, 0,
            1, 1, 0, 0,
            1, 100000, 0, 0,
            3, 100000, 0, 0,
        };
        run_highlevel_script(&pre, "hl_quota_up", 2, 8000, 44100, 44100, ops, 5, NULL, 0, 800);
        run_highlevel_script(&pre, "hl_quota_down", 2, 44100, 8000, 44100, ops, 5, NULL, 0, 800);
    }
    {
        /* E3: Adjust mid-stream, including a rejected Adjust (radius growth). */
        static const long long ops[] = {
            1, 200, 0, 0,
            2, 44100, 48000, 48000,   /* ok: upsample, radius shrinks */
            1, 200, 0, 0,
            2, 192000, 8000, 192000,  /* rejected: radius would exceed init radius */
            1, 200, 0, 0,
            2, 44100, 8000, 44100,    /* ok: back to init ratio */
            1, 100000, 0, 0,
            3, 100000, 0, 0,
        };
        run_highlevel_script(&pre, "hl_adjust", 2, 44100, 8000, 44100, ops, 8, NULL, 0, 2000);
    }
    {
        /* E4: EOF during leading-padding prime (clownresampler.h:1132-1133). */
        static const long long ops[] = {
            1, 100000, 0, 0,
            1, 100000, 0, 0,
            3, 100000, 0, 0,
        };
        static const long long chunks[] = { 2, 0, 10000 };
        run_highlevel_script(&pre, "hl_eof_prime", 2, 44100, 8000, 44100, ops, 3, chunks, 3, 2000);
    }

    {
        /* D7: MEDIUM-width kernels (taps 512/760), between the narrow
           ratios and the wide ones. Chunked feeds exercise position carry at these widths;
           the mid-script Adjust re-rates 44100->349 (radius 380) into
           44100->517 (radius 256). Appended AFTER the earlier scripts so
           their shared-PRNG streams stay byte-identical. */
        static const long long ops_mid[] = {
            1, 1500, 1000000, 0,
            1, 700, 1000000, 0,
            2, 44100, 517, 44100,
            1, 1800, 1000000, 0,
            1, 2000, 1000000, 0,
        };
        run_lowlevel_script(&pre, "ll_midwide", 2, 44100, 349, 44100, ops_mid, 5, 6000, 400);
    }

    fprintf(manifest, "  \"_end\": 0\n}\n");
    fclose(manifest);
    fprintf(stderr, "done\n");
    return 0;
}
