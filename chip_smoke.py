#!/usr/bin/env python3
"""Smoke run of the PyTorch port (hydrainfer_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py                 # every phase, one card
    python3 chip_smoke.py --phases build,kernels --out-dir DIR
    python3 chip_smoke.py --phases build,kernels,mla      # the quick MLA check
    python3 chip_smoke.py --phases build,kernels,llavanext,internvl   # the tiling towers
    python3 chip_smoke.py --phases build,kernels,deepseek,vl2   # DeepSeek MoE and VL2
    python3 chip_smoke.py --phases build,kernels,mixtral,gpt2   # Mixtral and GPT-2
    python3 chip_smoke.py --phases build,quant      # llava-7b-lm at int4 and fp8
    python3 chip_smoke.py --phases build,quality    # the quality scripts on the card
    python3 chip_smoke.py --phases build,kernels,tp  # tensor and expert parallelism
    python3 chip_smoke.py --phases build,kernels,pp  # pipeline parallelism
    python3 chip_smoke.py --phases build,drivers    # the speed drivers, the host packer

Phases, each printing one JSON line:
  build    compile the Hopper kernels of hydrainfer_tpu_torch/csrc (nvcc,
           sm_90a, one process per source) and report the build time, the
           library versions and whether torch has _grouped_mm;
  kernels  hold each kernel against its plain PyTorch version on the card at
           the shapes of the serving paths: K1-K4 at llava-7b-lm (serve),
           at qwen2-vl-2b-lm (vlm: GQA 6:1), at llava-13b-lm (next13b: MHA,
           40 heads, 2.4k-3k-token contexts) and at InternLM2.5-7B
           (internvl: GQA 4:1, K4's lm_head at the odd N = 92553, reported
           alone as `lm_head_*`), int8 weights, int8 KV, block size 16; K5 at the vlm phase's encode shape and in its
           causal form; K6 (latent attention), K3's single-plane write and K4
           at mla-2b-lm (mla: 16 heads over one 576-wide int8 plane), K6 in
           a decode and a mixed form, bf16 and f32; K3 at each path's decode
           step and prefill budget, bit for bit the host's quantize, with
           identical CUDA graph replays; K5 also at the llava encode shape
           (8 images of CLIP-L's 577 rows, 16 heads x d64, bf16, v a strided
           view of the fused qkv) and at the tiling towers' rounds (next13b:
           34 tiles of 577 rows; internvl: 48 tiles of InternViT's 1025
           rows; the plain version by groups of 4 tiles); and time each beside its
           bound and a PyTorch library call, eager and from a CUDA graph (K4
           per projection over M 1-2048, both its forms, with a decode-step
           sum and a prefill-budget sum); K2 and K4 also at the speculative
           verify step's shape (llava-7b-lm, 8 segments of 13 rows, T = 128,
           max_q 16; K4 on every projection at M = 128, lm_head included);
           K6, K3 and K4 at DeepSeek-V2-Lite (deepseek: the mla path's
           batches at V2-Lite's YaRN softmax scale; K4 also at the dense
           layer's and the shared experts' shapes, M 32 and 2048), K1-K4 at
           DeepSeek-VL2-Tiny's LM (vl2: MHA 10 x d128, K4's lm_head at N =
           129280) and K5 at its encode (28 tiles of SigLIP's 784 rows, 16
           heads of 72 padded to 80, the padding columns 0); and the MoE
           grouped product (torch._grouped_mm, a library call: no TPU kernel)
           at V2-Lite's experts, T = 32 and 2048, beside its bound, and the
           whole moe_ffn at T = 32 from a CUDA graph (`grouped_mm`), and the
           same at Mixtral-8x7B's experts (`grouped_mm_mixtral`); K1-K4 at
           Mixtral-8x7B (mixtral: GQA 4:1 x d128, int8 KV; K4 at qkv, o and
           lm_head, the experts being bf16) and K1-K3 at GPT-2 XL (gpt2: 25
           heads x d64 over a bf16 cache, K3 writing bf16 rows bit for bit;
           no K4: the weights are bf16); and K4's int4 (group 128) and fp8
           forms at llava-7b-lm's four projections, M 16 and 256 (the fp8
           lm_head alone too), weights quantized on the card by the port's
           quantize functions, each held to its plain version, beside its
           byte bound (int4: packed values and group scales) and torch.mm
           on the dequantized bf16 weight (rows quant_matmul_int4 and
           quant_matmul_fp8, paths quant_int4 and quant_fp8);
  tiny     serve tiny-lm and mla-tiny-lm in f32 through OfflineEngine on the
           card (decode steps from CUDA graphs) and on the CPU with the same
           weights and key floors, plain and with n-gram speculation at k = 3
           (two lookup-friendly requests, the verify steps graphed on the
           card): the greedy tokens and the verify counts must be identical;
  serve    serve llava-7b-lm (full width, int8 weights, int8 KV) through
           OfflineEngine on the card: every request must finish with its
           token count, every kernel must have launched in the measured run
           (K3's launches are also reported split into decode and prefill
           steps, as the vlm and mla phases do),
           a K=16 fused window must have run, and one prefill's logits must
           agree with the same model run through the plain PyTorch versions;
           then the same model serves the measured round's requests again
           with CUDA graphs off (`eager_round`): the tokens must be identical;
  quant    serve llava-7b-lm's language tower at full width and depth at
           int4 (group 128, lm_head int8) and then at fp8 (e4m3 per
           column), int8 KV, as the serve phase serves int8 (8 x 128 x 32,
           budget 256, K = 16 graphed windows): every request finishes,
           K1-K3 and K4's form for the mode launch in the measured round
           and K4's int8 form only for the lm_head (int4: 128 int4
           launches to each int8 one; fp8: none), one prefill's logits
           through the kernels agree with the plain versions, and a short
           round (2 x 8 tokens) from the graphs equals it with graphs off;
           it reports tokens/s, p50 TTFT, the decode step's device ms
           beside its byte bound (1.07 ms at int4, 1.97 at fp8), peak
           memory and weight bytes;
  quality  the port's quality scripts (hydrainfer_tpu_torch/evaluation) on the
           card: quant_quality's tiny Llama (vocab 2048, hidden 256, 4 layers,
           GQA 8:4) and DeepSeek-V3 MLA (q-LoRA, 8 experts top-2)
           checkpoints, each trained 400 steps on the card (HF
           transformers) and evaluated in the script's six configs (bf16,
           int8, int4, fp8, int8 KV, int8 + int8 KV) on 8 held-out
           sequences twice, through the kernels and through the plain
           versions: per config the NLLs within 0.01 nats, top-1 agreement
           of the two runs >= 0.99, K4's form for the config launched (the
           int8 form only for int4's lm_head) and K2 or K6 with K3; both
           tables printed. The trained Llama's correctness dumps (a
           word-level tokenizer saved beside it; 8 prompts x 32 tokens) at
           bf16, int8, int4 and fp8 on the card, compared with the card's
           bf16 dump, and the CPU's bf16 dump equal to it or first
           differing at a near tie; model_params for every ARCH_CONFIGS
           entry from shapes alone. llava-7b-lm at full width from one
           seeded bf16 tree quantized in turn: the six configs'
           all-position logits over 4 x 512 tokens (KL and top-1 against
           bf16 printed, no ordering checked: random weights), one
           all-position prefill's span and device time, the int4 config's
           logits against the plain versions (_logits_check), and
           getModelParamsCount() of the bf16 tree equal to param_count().
           Then K4 for the lm_head at every position (M 512, N 32064, f32
           out) in its int8, int4 and fp8 forms and K2 on a lone 512-row
           prefill (and through the all-position batch's 512 padded
           sequences: the same rows) as kernel rows of path "quality";
  spec     n-gram speculative decoding on llava-7b-lm (full width, int8
           weights, int8 KV): four lookup-friendly requests (a seeded 32-token
           sequence repeated four times, 128 tokens each) on an engine of 8
           (S floor 8, verify T = 128, max_q 16), spec_ngram_k 12 and then 0
           on the same model: verify steps must run, replaying their CUDA
           graph (captured once, in the warm-up round), and launch K2, K3 and
           K4; the tokens must equal the plain run's or first differ at a near
           tie; tokens/s, p50 TTFT, tokens per verify step, and the verify
           step's device ms beside a fused window's per step;
  sample   stochastic sampling on the same model: eight requests at
           temperature 0.8, top-k 40, top-p 0.95 through K = 16 graphed
           windows (the sampled keys captured in a warm-up round); top-k 1 at
           0.8 must equal greedy, a mixed batch must leave the greedy rows
           unchanged; on the card, the chain's draws (process_logits and the
           rejection-sampled verify) within TV 0.05 of their targets at
           N = 4000, and graph replays with the generator registered must draw
           fresh numbers; the sort kernels' device ms per step from a profiled
           round, and the chain alone from a CUDA graph;
  vlm      serve Qwen2-VL-2B (full width: bf16 vision tower, LM with int8
           weights and int8 KV) through OfflineEngine(node_type="EPD"): eight
           image requests of four sizes, encoded, prefilled (chunks mixing
           with decodes) and decoded; every request must finish with its
           token count, all five kernels must have launched in the measured
           round, a K=16 window must have run, one encode's features
           through K5 must agree with the tower run through the plain
           attention, and one image-bearing prefill's logits must agree with
           the same model run through the plain versions of K1-K4;
  llava    serve LLaVA-1.5-7B at full width from its random-weight name
           (random:llava-7b-lm+mm through getModelFactory: the bf16
           CLIP-L/14-336 tower to its feature layer, 23 of 24 layers, 577
           rows an image through K5, the bf16 projector, llava-7b-lm with
           int8 weights and int8 KV) through OfflineEngine(node_type="EPD"):
           eight requests of one 336 x 336 image and 32 characters, 32
           tokens each, budget 2048, K=16 windows; every request must finish
           with its token count, K1-K5 must launch in the measured round,
           one encode's features through K5 must agree with the tower run
           through the plain attention, one image-bearing prefill's logits
           with the plain versions'; then a mixed round (4 text requests of
           128 tokens decoding while 4 image requests are encoded) on a
           fresh engine with the whole-tower encode and on one with the
           layer-chunked encode (segments of 6 layers: 4 an encode): every
           request must finish, each request's tokens must be the same in
           both or first differ at a near tie, and no window may pass 4
           steps while the chunked encode runs; it reports each setting's
           text-token gaps while the encode is in flight, tokens/s, p50
           TTFT, the encode's device span and the graph keys captured;
  disagg   EPD disaggregation in process on the one card: the llava phase's
           model (its factory reused, one weight copy shared by every
           node) served by Clusters built from config/cluster/single.yaml
           (one EPD node, the reference), hybrid.yaml (EP + D), general.yaml
           (E + P + D) and general's P + D alone (text requests only), with
           explicit block counts and the decoding nodes' running cap at 16:
           8 image requests and 8 text requests of 128 tokens, 32 tokens
           each, through Cluster.add_request with every node's step loop
           running, a warm-up and a measured round; every request must
           finish with its tokens and equal the EPD node's or first differ
           at a near tie, each node must launch its type's kernels only (E:
           K5; P: K2-K4, no K1; D: K1, K3, K4, no K2 or K5; EP: K2-K5), the
           first migrated KV and image blocks must equal the source's bit
           for bit, and every node must end with no request migrating, its
           free blocks back and its token slots whole; it reports tokens/s
           and p50 TTFT (image, text) beside the EPD node's, the pulls (MB,
           device ms, copy GB/s beside 2 x bytes over the HBM rate), the
           decode windows dispatched during a pull, the graph keys captured
           while serving and peak memory; general's nodes run with
           log_latency_breakdown on, and each request of its measured round
           must log one breakdown under the JAX stage names (an image
           request its encode, two pulls, prefill and decode; a text one a
           pull, prefill and decode), every span non-negative and within
           the request's wall time;
  process  the process deployment on the card: LLaVA-1.5-7B at full width
           (random:llava-7b-lm+mm, int8 weights, int8 KV), built by each
           node process from the seed, E + P + D as three spawned processes
           through ProcessCluster (general.yaml with the disagg phase's
           overrides and pools, budget search off at 2048): a lone image
           request, after which the blocks of its KV pull (P -> D) and
           image pull (E -> P) must equal the source's bit for bit (read
           back over RPC); a warm-up and a measured round of the disagg
           phase's 16 requests: every request must finish with its tokens,
           equal to the one-EPD-node reference's (the disagg phase's, else
           built here from the same factory) or first differing at a near
           tie, each node must launch only its type's kernels (DISAGG_LAUNCH,
           counts over RPC), every pull must ride CUDA IPC, no request may
           be left migrating, every pool's available blocks must be back and
           the parent must allocate no card memory for the cluster; then the
           D process is killed with 4 requests decoding on it: they must be
           terminated, D respawned, and an image and a text request served
           after. Then `python -m hydrainfer_tpu_torch.entrypoint.entrypoint
           --config config/cluster/hybrid.yaml cluster.deployment=process`
           (EP + D) as a child: 16 streaming chats at once, 8 with an
           image_url, each to [DONE] with its 32 deltas; /metrics must list
           both nodes with every pull over IPC; SIGTERM must give exit 0,
           and no node process may be left alive or on the card. It reports
           boot s, tokens/s and p50 TTFT beside the in-process numbers, the
           pulls (count, MB, host ms each, GB/s beside 2 x bytes over the
           HBM rate), each child's peak memory, the card's used memory, and
           how two processes' GEMM loops share the card (`process.json`);
  llavanext  serve LLaVA-NeXT-13B at full width (the llava-v1.6-vicuna-13b
           shapes, random weights from the seed: the bf16 CLIP-L/14-336
           tower to layer -2 over anyres tiles, the projector and the
           image_newline, the default pinpoints, llava-13b-lm with int8
           weights and int8 KV; PIL-and-numpy anyres tiling) through
           OfflineEngine(node_type="EPD"): eight requests of one image (two
           each at 672 x 672, 480 x 640, 336 x 672, 1008 x 336: 2928, 2340,
           1752, 2376 image tokens) and 32 characters, 32 tokens each, budget
           2048, K = 16 windows, a warm-up, measured and profiled round;
           every request must finish with its tokens, K1-K5 must launch, an
           image prompt's prefill must span two or more steps, one image's
           tiles through K5 must give the plain attention's features, and
           the 2992-token prompt of a 672 x 672 image, prefilled in chunks
           of 2048, the plain versions' logits in each chunk (read at every
           64th row and each chunk's last; the bf16 path held in mean
           |error|, _logits_check); then the same
           requests on an in-process Cluster from config/cluster/hybrid.yaml
           (EP + D, one shared factory, explicit pools): every request's
           tokens must equal the EPD node's or first differ at a near tie,
           the first migrated KV blocks must equal the source's bit for bit,
           every node must launch its type's kernels and end with no request
           migrating and its blocks back; then, where safetensors is
           installed, a tiny LLaVA-NeXT checkpoint written with
           safetensors.numpy must give the same greedy tokens through
           getModelFactory(path) on the card and on the CPU. It reports
           tokens/s and p50 TTFT (EPD and EP + D), the encode walls and one
           whole-round encode's device time, tiles and image tokens a round
           and peak memory;
  internvl serve InternVL2-8B at full width (OpenGVLab/InternVL2-8B's
           widths, random weights from the seed: the bf16 InternViT-300M-448px,
           the pixel shuffle, the mlp1 projector, InternLM2.5-7B with int8
           weights and int8 KV) through OfflineEngine(node_type="EPD"): eight
           requests of one image (two each at 448 x 448, 448 x 896, 896 x
           1344, 480 x 640: 1, 3, 7, 13 tiles, 256 tokens a tile) with the
           llavanext phase's checks on one EPD node (the 13-tile prompt,
           3392 tokens, prefilled in chunks) and tiny-checkpoint check (the
           original InternVLChatModel layout with an InternLM2 LM), and the
           same reports, plus K4's lm_head launches at N = 92553;
  mla      serve mla-2b-lm (DeepSeek-V2-Lite-shaped MLA, full width, int8
           o_proj/gate_up/down/lm_head, int8 single-plane latent KV) through
           OfflineEngine: 32 requests, chunked prefill mixing with decodes,
           K=16 windows; every request must finish with its token count, K6,
           K3 and K4 must have launched in the measured round and K1 and K2
           never, and one prefill's logits through the kernels must agree
           with the plain versions;
  deepseek serve DeepSeek-V2-Lite at full width (the widths and depth of
           deepseek-ai/DeepSeek-V2-Lite's config.json, random weights from the
           seed: 27 layers, MLA over the int8 latent cache, YaRN x40, one
           dense layer, 26 layers of 64 routed experts, 6 a token, and 2
           shared; int8 as quantize_tree picks, the experts bf16) as the mla
           phase serves mla-2b-lm, 32 tokens a request: every request must finish, K6, K3 and K4
           launch and K1 and K2 never, a K = 16 window replays its graph (the
           MoE dispatch captured), a graphs-off round gives identical tokens,
           and a 512-token prefill in chunks of 256 through the kernels gives
           the plain versions' logits at all 27 layers (mean |error|; the
           f32 reference built one layer at a time, its MoE layers' plain
           path routed as the kernel path);
           it reports the routing choices that differ between the two paths
           (each with its score gap), the decode step's device ms beside its
           byte bound, the distinct experts a decode step touches a layer,
           and the tiny-checkpoint check (q-LoRA, noaux_tc, YaRN);
  vl2      serve DeepSeek-VL2-Tiny at full width (deepseek-ai/deepseek-vl2-tiny's
           widths, random weights from the seed: the bf16 SigLIP-so400m, its
           heads padded 72 -> 80 for K5, the 2x2 downsample projector, a
           12-layer MoE LM with int8 weights and int8 KV) with the
           llavanext phase's checks, on one EPD node and on EP + D: eight
           requests, two each at 384 x 384, 768 x 768, 1152 wide x 384 and
           384 wide x 768 (2, 5, 4, 3 tiles; 5776 image tokens a round); it
           reports the encode's wall and device time against the tower's
           operations, and the tiny-checkpoint check (the original VL2
           naming);
  mixtral  serve Mixtral-8x7B at its published widths and 20 of its 32
           layers (mistralai/Mixtral-8x7B-v0.1's config.json, random weights
           from the seed: GQA 4:1 x d128 over the int8 KV cache, every layer
           8 experts of 14336, 2 a token, bf16; int8 qkv, o_proj and lm_head;
           56.4 GB of experts: 32 layers would not fit) as the deepseek phase
           serves V2-Lite, with 32 tokens a request: K1-K4 and the grouped
           product launch, graphs-off tokens identical, the logits check at
           all 20 layers, the routing flips, the decode step's device ms
           beside its byte bound, and the tiny-checkpoint check (f32, graphs
           off on the card);
  gpt2     serve GPT-2 XL at full width and depth (openai-community/gpt2-xl's
           config.json, random weights from the seed, bf16 weights and KV):
           32 requests x 128-token prompts x 32 tokens, budget 2048, single
           graphed steps (GPT-2 takes no fused window): K1, K2 and K3 launch
           and K4 never, graphs-off tokens identical, a 512-token prefill's
           logits through the kernels against the plain versions, and the
           tiny-checkpoint check (f32, graphs on);
  tp       tensor and expert parallelism at tp_size 2, both ranks on the
           card (parallel/mesh.py), decode from CUDA graphs: llava-7b-lm
           (int8 weights, int8 KV) on one PD node at tp 1 and then at tp 2
           over the same seeded tensors, 8 x 128 x 32: K1-K4 launch at the
           shard shapes (16 q / 16 kv heads x d128; K4 at 4096 x 6144, 2048
           x 4096, 4096 x 11008, 5504 x 4096 and the lm_head's 4096 x 16032,
           as each wrapper records them), the tokens equal tp 1's or first
           differ at a near tie (_near_tie; the count and the first gap
           reported); DeepSeek-V2-Lite at full width and depth the same way,
           8 x 128 x 32: MLA over the latent plane every rank holds a copy
           of (K6 at 8 heads), 32 of the 64 experts a rank (the grouped
           product at 32 experts), K4 at its shard shapes, K1 and K2 never,
           and the routing choices of a 256-token prefill at tp 2 against
           tp 1 (routing_first_layer_*); then a P node at tp 2 hands off to
           a D node at tp 1 (the KV blocks gathered from the two shards) and
           its tokens follow the same rule against tp 1's. Each part reports
           tokens/s and a K = 16 decode step's device ms at tp 1 and tp 2,
           and one prefill's logits at both against the f32 reference. The
           kernels phase holds K1-K4 and K6 at these shapes (paths tp and
           tp_mla) and the grouped product at one rank's 32 experts
           (`grouped_mm_tp`);
  pp       pipeline parallelism at pp_size 2, both stages on the card
           (parallel/pipeline.py), decode from CUDA graphs: llava-7b-lm
           (int8 weights, int8 KV) on one PD node at pp 1 (K = 1 windows)
           and then at pp 2 over the same seeded tensors (layers 0-15 and
           16-31), 8 x 128 x 32: both step forms run (the relay for prefill
           and mixed steps, the microbatched decode for pure decode steps),
           K1-K4 launch (counted by form; inside the microbatched form K1
           over 4 sequences and K4 at M 4, as each wrapper records them),
           the tokens equal pp 1's or first differ at a near tie, and one
           decode step of S 8 is timed from CUDA graphs at pp 1 and in both
           forms at pp 2; Qwen2-VL-2B's EPD node (K5 in its tower, the
           image splice and M-RoPE before the relay, 14 layers a stage) on
           the vlm phase's 8 images x 32 tokens the same way; then a P node
           at pp 2 hands off to a D node at pp 1 (the KV blocks gathered from
           the two stages' layer runs) under the same token rule. The
           kernels phase holds K1-K4 at the microbatch shapes (path pp: K1
           over 4 sequences, K3 4 rows, K4 at M 4);
  drivers  the port's engine-driven speed drivers (hydrainfer_tpu_torch/
           evaluation) at published widths: interference.run_analysis on
           Qwen2-VL-2B (the vlm phase's factory: bf16 ViT, int8 LM and KV;
           batch 8, prompt 128, gen 16: decode alone, encodes alone, the
           colocated mix), ab_bench on llava-7b-lm ("int8;quant=int8;
           kv_int8=1" against "fp8;quant=fp8;kv_int8=1", 2 interleaved rounds
           of 8 x 128 x 16; every request of both variants finishes) and
           spec_bench on llava-7b-lm (the A/B's int8 weights, batch 2, one
           round; speculation's tokens equal greedy's or first differ at a
           near tie), each driver's launches counted (K1-K5 and K4's fp8
           form must launch); then the native host packer
           (csrc/hostops.cpp): whether it built and its build seconds, and
           the mean microseconds of one build() against the Python packer's,
           timed on the host over the plans of one serve-shaped round
           (llava-7b-lm int8, 8 x 128 x 16, budget 256, K = 16 windows), by
           decode and prefill plan, each native buffer equal to the Python
           packer's bit for bit. None of its numbers is a claim;
  online   serve llava-7b-lm (full width, int8 weights, int8 KV) online
           through the real entry point, run as a child process: `python -m
           hydrainfer_tpu_torch.entrypoint.entrypoint --config
           config/serve.yaml` with the model overrides (one EPD node, 64
           running requests, K=8 windows, the budget search at tpot_slo 0.4,
           an auto-sized KV pool); it reports the boot seconds, the budgets
           and search fallbacks (which must be 0), the KV pool and the graph
           keys; serves one lone /v1/completions request and a burst of 64
           streaming chats at once over HTTP (every stream must end in
           [DONE] with its 128 deltas; first-delta and inter-delta times
           and tokens/s on the client's clock; K1-K4 must launch in the
           burst); checks /health, a 400 for a malformed body, a chat at
           temperature 0.7 streamed to [DONE] with its 16 deltas, that an
           idle second launches no kernel, and that
           SIGTERM ends the child with 0; then the port's OfflineEngine,
           built here from the same file and overrides, must give the lone
           request's text character for character.
Every serving engine runs the boot warm-up (the shape-key floors raised to
the serving envelope, the decode keys captured as CUDA graphs) and serves a
warm-up round before the measured one; the measured round's decode steps are
graph replays (their kernel launches counted), it may capture no key, and
the graph pool must fit in the headroom an auto-sized KV pool leaves: each
serving phase reports `graphs`. The tp and pp phases serve one round a
setting instead (a pipeline-parallel node has no boot warm-up, so its
decode key is captured in that round).
Then the card's name and power limit, a "kernels" JSON line (one row per
kernel and serving path, K3 one per path and form, K5 one at each image
path's encode: that path's shapes and its measured round's launches),
and as the last
line {"ok": true, "device": {...}}. Any failed phase exits non-zero without
that line. Details (per-shape timings, ptxas reports, the profile) go to
--out-dir (default chip_smoke_out/). Imports nothing of JAX or of the JAX
package.
"""
import argparse
import asyncio
import contextlib
import gc
import json
import math
import os
import subprocess
import sys
import time
import traceback

OUT_DIR = "chip_smoke_out"
HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3
BF16_FLOPS = 989e12              # H100 SXM dense bf16 tensor-core peak
# a bf16 + int8-KV prefill through the kernels may lie at most this many times
# as far from the f32 run as the same prefill through the plain versions (the
# kernels compute K/V and scales in f32 where the plain versions round to bf16)
LOGITS_RATIO = 1.1
SEED = 0

KERNEL_SOURCES = {
    "mha_decode": ("hydrainfer_tpu_torch/csrc/mha_decode.cu",
                   "hydrainfer_tpu/ops/pallas/mha_decode.py:356"),
    "paged_attention": ("hydrainfer_tpu_torch/csrc/paged_attention.cu",
                        "hydrainfer_tpu/ops/pallas/paged_attention.py:405"),
    "kv_writer": ("hydrainfer_tpu_torch/csrc/kv_writer.cu",
                  "hydrainfer_tpu/ops/pallas/kv_writer.py:133"),
    "quant_matmul": ("hydrainfer_tpu_torch/csrc/quant_matmul.cu",
                     "hydrainfer_tpu/ops/pallas/quant_matmul.py:64"),
    "mha_varlen": ("hydrainfer_tpu_torch/csrc/mha_varlen.cu",
                   "hydrainfer_tpu/ops/pallas/mha_varlen.py:128"),
    # the same pallas_call in its CKV = 1 (single-plane latent) form
    "paged_attention_latent": ("hydrainfer_tpu_torch/csrc/paged_attention_latent.cu",
                               "hydrainfer_tpu/ops/pallas/paged_attention.py:405"),
    # K4's int4 and fp8 forms: no pallas_call; the JAX package runs them
    # through XLA's dequant-in-dot (its qmatmul, ops/quant.py:169-203)
    "quant_matmul_int4": ("hydrainfer_tpu_torch/csrc/quant_matmul_int4.cu",
                          "hydrainfer_tpu/ops/quant.py:169"),
    "quant_matmul_fp8": ("hydrainfer_tpu_torch/csrc/quant_matmul_fp8.cu",
                         "hydrainfer_tpu/ops/quant.py:169"),
}
# the quant phase: llava-7b-lm's language tower at each mode (int8 KV), the
# serve phase's traffic; the int4 and fp8 K4 rows of the kernels phase
QUANT_MODES = ("int4", "fp8")
QUANT_ARCH = "llava-7b-lm"
QUANT_EAGER_REQUESTS, QUANT_EAGER_TOKENS = 2, 8
# the quality phase: the quant_quality script's two checkpoints trained on
# the card (its 400 steps, 8 held-out sequences), its six configs on
# llava-7b-lm at full width (4 x 512 tokens), and the correctness dumps of
# the trained tiny Llama
QUALITY_TRAIN_STEPS, QUALITY_SEQS = 400, 8
QUALITY_ARCH, QUALITY_FULL_SEQS, QUALITY_FULL_T = "llava-7b-lm", 4, 512
QUALITY_DUMP_PROMPTS, QUALITY_DUMP_TOKENS = 8, 32
QUALITY_NLL_NATS, QUALITY_TOP1 = 0.01, 0.99
SERVE_KERNELS = ("mha_decode", "paged_attention", "kv_writer", "quant_matmul")
VLM_KERNELS = SERVE_KERNELS + ("mha_varlen",)
# the MLA path's kernels; K1 and K2 must not run on it
MLA_KERNELS = ("paged_attention_latent", "kv_writer", "quant_matmul")
# 32 tokens a request (128 before the pp phase joined the script: the
# script keeps inside its time limit)
MLA_ARCH, MLA_REQUESTS, MLA_PROMPT, MLA_TOKENS = "mla-2b-lm", 32, 128, 32
# the vlm phase's images (height, width), two of each size: 64, 144, 256
# and 384 image tokens, 6784 patches in all
VLM_IMAGES = [(224, 224), (336, 336), (448, 448), (448, 672)] * 2
# Qwen2-VL-2B: the vision tower of its config.json (head_dim 80, merger out
# 1536), the qwen2-vl-2b-lm language model and its M-RoPE sections
VLM_VISION = dict(depth=32, embed_dim=1280, hidden_size=1536, num_heads=16)
VLM_ARCH, VLM_MROPE = "qwen2-vl-2b-lm", (16, 24, 24)
# the llava phase: LLaVA-1.5-7B at full width from its random-weight name (the
# CLIP-L/14-336 tower to its feature layer, 23 of 24 layers, and the projector
# in bf16; llava-7b-lm with int8 weights and int8 KV at 0.05): requests of
# one 336 x 336 image and LLAVA_TEXT text characters, LLAVA_TOKENS tokens
# each; then the mixed round (4 text requests of LLAVA_MIXED_TOKENS tokens
# decoding while 4 image requests are encoded), with the whole tower in one
# step and in segments of LLAVA_CHUNK_LAYERS layers (4 segments of 6, 6, 6
# and 5)
LLAVA_MODEL = "random:llava-7b-lm+mm"
LLAVA_REQUESTS, LLAVA_TEXT, LLAVA_TOKENS = 8, 32, 32
LLAVA_MIXED_TOKENS, LLAVA_CHUNK_LAYERS = 128, 6
# the llavanext phase: LLaVA-NeXT-13B, the llava-v1.6-vicuna-13b shapes (the
# CLIP-L/14-336 tower to layer -2, the 1024 -> 5120 -> 5120 projector, the
# 5120-wide image_newline, the default pinpoints, llava-13b-lm), 8 requests
# of one image and MM_TEXT characters, MM_TOKENS tokens each, two at each
# (h, w) size: 5, 5, 3 and 4 tiles, 2928, 2340, 1752 and 2376 image tokens
NEXT_ARCH = "llava-13b-lm"
NEXT_IMAGES = [(672, 672), (480, 640), (336, 672), (1008, 336)] * 2
NEXT_KV_BLOCKS, NEXT_IMAGE_BLOCKS = 2048, 32
# the internvl phase: InternVL2-8B, the widths of OpenGVLab/InternVL2-8B's
# config.json: InternViT-300M-448px, the 0.5 pixel shuffle (256 tokens a
# tile), the mlp1 projector, InternLM2.5-7B (kept here: the JAX package has no
# random: name for it); two requests at each (h, w) size: 1, 3, 7 and 13
# tiles, 256, 768, 1792 and 3328 image tokens
INTERNVL_IMAGES = [(448, 448), (448, 896), (896, 1344), (480, 640)] * 2
INTERNVL_VIT = dict(hidden_size=1024, intermediate_size=4096, n_layers=24, n_heads=16,
                    image_size=448, patch_size=14, qk_normalization=False,
                    layer_norm_eps=1e-6)
INTERNLM2_7B = dict(n_layers=32, hidden_size=4096, intermediate_size=14336, n_qo_heads=32,
                    n_kv_heads=8, head_dim=128, vocab_size=92553,
                    max_position_embeddings=32768, rope_theta=1e6, rms_norm_eps=1e-5)
INTERNVL_KV_BLOCKS, INTERNVL_IMAGE_BLOCKS = 2048, 64
MM_TEXT, MM_TOKENS, MM_BUDGET = 32, 32, 2048
# the deepseek phase: DeepSeek-V2-Lite, the text config of
# deepseek-ai/DeepSeek-V2-Lite's config.json (its rope, routing and MLA
# fields; the port's deepseek_decoder_config reads it as from the file):
# 27 layers x 2048, 16 heads, MLA (kv_lora 512, rope 64, nope 128, v 128, no
# q-LoRA), the first layer dense (10944), then 64 routed experts of 1408, 6 a
# token (greedy softmax, norm_topk_prob false, scaling 1.0) and 2 shared;
# vocab 102400; YaRN factor 40 over 4096 positions, mscale = mscale_all_dim =
# 0.707, 163840 positions. 32 requests x 128-token prompts x 32 tokens (the
# mla phase's requests)
DEEPSEEK_V2_LITE = {
    "model_type": "deepseek_v2", "vocab_size": 102400, "hidden_size": 2048,
    "intermediate_size": 10944, "moe_intermediate_size": 1408, "num_hidden_layers": 27,
    "num_attention_heads": 16, "num_key_value_heads": 16, "n_shared_experts": 2,
    "n_routed_experts": 64, "routed_scaling_factor": 1.0, "kv_lora_rank": 512,
    "q_lora_rank": None, "qk_rope_head_dim": 64, "v_head_dim": 128, "qk_nope_head_dim": 128,
    "topk_method": "greedy", "n_group": 1, "topk_group": 1, "num_experts_per_tok": 6,
    "first_k_dense_replace": 1, "norm_topk_prob": False, "scoring_func": "softmax",
    "max_position_embeddings": 163840, "rope_theta": 10000, "rms_norm_eps": 1e-6,
    "rope_scaling": {"type": "yarn", "factor": 40, "original_max_position_embeddings": 4096,
                     "beta_fast": 32, "beta_slow": 1, "mscale": 0.707,
                     "mscale_all_dim": 0.707},
    "tie_word_embeddings": False}
DEEPSEEK_REQUESTS, DEEPSEEK_PROMPT, DEEPSEEK_TOKENS = 32, 128, 32
# the mixtral phase: Mixtral-8x7B, the widths of mistralai/Mixtral-8x7B-v0.1's
# config.json: 4096 wide, 32 q / 8 kv heads of 128 (GQA 4:1), 8 experts of
# 14336, 2 a token (softmax, renormalised), vocab 32000, rope_theta 1e6,
# rms_norm_eps 1e-5, no sliding window. Its depth is cut to MIXTRAL_LAYERS of
# 32: bf16 experts take 2.82 GB a layer (90 GB at 32 layers); 20 layers hold
# 56.4 GB, leaving room for the pools and a one-layer f32 reference (5.6 GB
# of f32 experts). 32 requests x 128-token prompts x 32 tokens
MIXTRAL_8X7B = {
    "architectures": ["MixtralForCausalLM"], "model_type": "mixtral", "vocab_size": 32000,
    "hidden_size": 4096, "intermediate_size": 14336, "num_hidden_layers": 32,
    "num_attention_heads": 32, "num_key_value_heads": 8, "num_local_experts": 8,
    "num_experts_per_tok": 2, "max_position_embeddings": 32768, "rope_theta": 1e6,
    "rms_norm_eps": 1e-5, "sliding_window": None, "tie_word_embeddings": False}
MIXTRAL_LAYERS = 20
MIXTRAL_REQUESTS, MIXTRAL_PROMPT, MIXTRAL_TOKENS = 32, 128, 32
# the gpt2 phase: GPT-2 XL, openai-community/gpt2-xl's config.json: 48 layers x
# 1600, 25 heads of 64, inner 6400 (4 x), vocab 50257, 1024 positions,
# gelu_new; bf16 weights (3.1 GB) and a bf16 KV cache; single-step windows.
# 32 requests x 128-token prompts x 32 tokens (positions end at 160 < 1024)
GPT2_XL = {"architectures": ["GPT2LMHeadModel"], "model_type": "gpt2", "vocab_size": 50257,
           "n_embd": 1600, "n_layer": 48, "n_head": 25, "n_positions": 1024,
           "activation_function": "gelu_new", "layer_norm_epsilon": 1e-5}
GPT2_REQUESTS, GPT2_PROMPT, GPT2_TOKENS = 32, 128, 32
# the vl2 phase: DeepSeek-VL2-Tiny, deepseek-ai/deepseek-vl2-tiny's
# config.json: SigLIP-so400m at 384 (27 layers x 1152, 16 heads of 72, MLP
# 4304, 28 x 28 patches), the 2x2 downsample projector (depth 2, 4608 ->
# 1280 -> 1280: 196 tokens a tile), the default six candidate resolutions,
# and its language_config: 12 layers x 1280, 10 MHA heads of 128, the first
# layer dense (6848), then 64 experts of 896, 6 a token (greedy softmax,
# norm_topk_prob false) and 2 shared, vocab 129280. The file also lists
# kv_lora_rank with use_mla false: deepseek_decoder_config keys MLA on
# kv_lora_rank (as JAX's) and refuses that pair, so the MLA fields are left
# out here
VL2_VISION = dict(hidden_size=1152, intermediate_size=4304, n_layers=27, n_heads=16,
                  image_size=384, patch_size=14)
VL2_N_EMBED = 1280
VL2_TINY_LM = {
    "model_type": "deepseek_v2", "vocab_size": 129280, "hidden_size": 1280,
    "intermediate_size": 6848, "moe_intermediate_size": 896, "num_hidden_layers": 12,
    "num_attention_heads": 10, "num_key_value_heads": 10, "n_shared_experts": 2,
    "n_routed_experts": 64, "routed_scaling_factor": 1.0, "topk_method": "greedy",
    "n_group": 1, "topk_group": 1, "num_experts_per_tok": 6, "first_k_dense_replace": 1,
    "norm_topk_prob": False, "scoring_func": "softmax", "max_position_embeddings": 4096,
    "rope_theta": 10000, "rms_norm_eps": 1e-6, "tie_word_embeddings": False}
# two requests at each (h, w): 2, 5, 4 and 3 tiles; 421, 1023, 813 and 631
# image tokens (28 tiles, 5776 image tokens a round)
VL2_IMAGES = [(384, 384), (768, 768), (384, 1152), (768, 384)] * 2
VL2_KV_BLOCKS, VL2_IMAGE_BLOCKS = 1024, 32
# the tp phase: tensor and expert parallelism at TP_SIZE ranks, both on the
# one card. llava-7b-lm (int8 weights, int8 KV) at 8 x 128 x 32 with budget
# 256, and DeepSeek-V2-Lite at full width and depth at 8 x 128 x 32 with
# budget 1024 (one prefill step), each served at tp 1 and then at tp 2 on
# the same seeded weights; then a P node at tp 2 hands off to a D node at tp
# 1 on llava-7b-lm
TP_SIZE = 2
# (64 tokens a request before the drivers phase joined the script: the
# script keeps inside its time limit)
TP_REQUESTS, TP_PROMPT, TP_TOKENS, TP_MLA_TOKENS = 8, 128, 32, 32
TP_BUDGET, TP_MLA_BUDGET = 256, 1024
# the pp phase: pipeline parallelism at PP_SIZE stages, both on the one
# card. llava-7b-lm (int8 weights, int8 KV) on the tp phase's traffic at pp
# 1 (K = 1 windows) and then at pp 2 on the same tensors (layers 0-15 and
# 16-31); Qwen2-VL-2B's EPD node (28 layers, 14 a stage) on the vlm phase's
# 8 images at PP_VLM_TOKENS tokens, the same way; then a P node at pp 2
# hands off to a D node at pp 1 on llava-7b-lm
PP_SIZE = 2
PP_VLM_TOKENS = 32
# architectures the script defines itself, by the names PATH_SHAPES uses
# (the "-tp2" ones: what one of two ranks runs, its widths split)
LOCAL_ARCHS = {"internlm2-7b": lambda: _decoder_cfg(**INTERNLM2_7B),
               "deepseek-v2-lite": lambda: _deepseek_cfg(DEEPSEEK_V2_LITE),
               "deepseek-vl2-tiny-lm": lambda: _deepseek_cfg(VL2_TINY_LM),
               "mixtral-8x7b": lambda: _mixtral_cfg(MIXTRAL_LAYERS),
               "gpt2-xl": lambda: _gpt2_cfg(),
               "llava-7b-lm-tp2": lambda: _tp_rank_cfg(_random_arch("llava-7b-lm")),
               "deepseek-v2-lite-tp2": lambda: _tp_rank_cfg(_deepseek_cfg(DEEPSEEK_V2_LITE))}
# the MoE architectures' shared experts (the moe_intermediate_size of all
# n_shared_experts in one MLP): K4's shapes beside the dense layer's
MOE_TEXT = {"deepseek-v2-lite": DEEPSEEK_V2_LITE, "deepseek-vl2-tiny-lm": VL2_TINY_LM,
            "deepseek-v2-lite-tp2": dict(DEEPSEEK_V2_LITE, moe_intermediate_size=(
                DEEPSEEK_V2_LITE["moe_intermediate_size"] // TP_SIZE))}


def _decoder_cfg(**kw):
    from hydrainfer_tpu_torch.models.decoder import DecoderConfig
    return DecoderConfig(**kw)


def _random_arch(name: str):
    from hydrainfer_tpu_torch.models.random_init import ARCH_CONFIGS
    return ARCH_CONFIGS[name]


def _tp_rank_cfg(cfg, tp: int = TP_SIZE):
    """The DecoderConfig one of tp ranks runs (parallel/mesh.py:rank_config:
    its heads), with its MLP width, vocabulary and experts split too: the
    shapes its kernels see."""
    from dataclasses import replace
    from hydrainfer_tpu_torch.parallel.mesh import rank_config, tp_layout
    return replace(rank_config(cfg, tp_layout(cfg, tp)),
                   intermediate_size=cfg.intermediate_size // tp,
                   vocab_size=cfg.vocab_size // tp, n_experts=cfg.n_experts // tp)


def _deepseek_cfg(text_cfg: dict):
    from hydrainfer_tpu_torch.models.deepseek_v3 import deepseek_decoder_config
    return deepseek_decoder_config(text_cfg)


def _mixtral_cfg(n_layers: int):
    """Mixtral-8x7B's decoder config, as the port's factory reads the file,
    at n_layers."""
    from dataclasses import replace
    from hydrainfer_tpu_torch.models.mixtral import mixtral_decoder_config
    return replace(mixtral_decoder_config(MIXTRAL_8X7B), n_layers=n_layers)


def _gpt2_cfg():
    from hydrainfer_tpu_torch.models.gpt2 import gpt2_config_from_hf
    return gpt2_config_from_hf(GPT2_XL)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def save(name: str, obj) -> None:
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, name), "w") as f:
        json.dump(obj, f, indent=1)


def bound_ms(n_bytes: float, flops: float):
    """Least time for the work: the larger of bytes over HBM bandwidth and
    operations over the bf16 peak (the main path's inputs are bf16/int8)."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean ms per call over `iters` calls, by CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, calls: int = 20, replays: int = 5, generator=None) -> float:
    """Mean ms per call of `calls` calls captured in one CUDA graph and
    replayed `replays` times: the card's time without the host's launch cost,
    which is most of time_ms for a kernel of a few tens of microseconds.
    `generator`: the torch.Generator fn draws from, registered with the
    graph."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):       # warm up off the capturing stream
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    if generator is not None:
        graph.register_generator_state(generator)
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * calls)


# ---------------------------------------------------------------- phase: build

def ptxas_entries(logs: dict) -> dict:
    """{kernel: {entry function (mangled): {"registers", "spill_stores"}}}
    from nvcc's -Xptxas -v report (each K4 form is its own entry)."""
    import re
    out = {}
    for name, log in logs.items():
        entries, cur = {}, None
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '([^']+)'", line)
            if m:
                cur = entries.setdefault(m.group(1), {})
            elif cur is not None and "spill stores" in line:
                cur["spill_stores"] = int(re.search(r"(\d+) bytes spill stores", line).group(1))
            elif cur is not None and "Used" in line and "registers" in line:
                cur["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
        out[name] = entries
    return out


def phase_build() -> dict:
    from hydrainfer_tpu_torch.ops.cuda import build
    import torch
    free, total = torch.cuda.mem_get_info()
    t0 = time.perf_counter()
    per_kernel = build.build_all()
    seconds = time.perf_counter() - t0
    save("ptxas.json", {"logs": build.build_logs, "entries": ptxas_entries(build.build_logs)})
    versions = {}
    for mod in ("transformers", "safetensors", "PIL"):
        try:
            versions[mod] = __import__(mod).__version__
        except ImportError:
            versions[mod] = "absent"
    versions["torch"] = torch.__version__
    return {"phase": "build", "ok": True, "seconds": seconds,
            "card_free_bytes_at_start": free, "card_total_bytes": total,
            "per_kernel_s": per_kernel, "nvcc": build.nvcc_path(), "versions": versions,
            # the MoE dispatch's grouped product (ops/moe.py) needs it
            "torch_grouped_mm": hasattr(torch, "_grouped_mm")}


# -------------------------------------------------------------- phase: kernels

# K1-K4 run on the serve and vlm paths, K6, K3 and K4 on the mla path; the
# kernels phase checks and times each at the shapes its path gives it.
# decode: K1's (K6's) window, (q_len, kv_len) per sequence; mixed: K2's (K6's)
# batch (prefill chunks, a chunked continuation, decodes), padded to T rows;
# kv_decode, kv_prefill: K3's (T, real rows) in a decode step (one row a
# sequence, T as the path's measured round writes it) and in a prefill
# budget; gemm_m: the M of K4's kernels-line row; budget: the path's token
# budget, the M of K4's prefill sum.
_VLM_PROMPTS = [64 + (h // 28) * (w // 28) for h, w in VLM_IMAGES]   # 128..448
PATH_SHAPES = {
    "serve": dict(arch="llava-7b-lm",
                  decode=[(1, 130 + 7 * s) for s in range(8)],
                  mixed=[(128, 128), (128, 128), (64, 192), (1, 150), (1, 161),
                         (1, 144), (100, 100), (1, 139)], T=512, kv_decode=(8, 8),
                  kv_prefill=(512, 452), budget=256),
    # 16 tokens into the decode; the 2048-token budget's first chunks
    "vlm": dict(arch=VLM_ARCH,
                decode=[(1, n + 16) for n in _VLM_PROMPTS],
                mixed=[(n, n) for n in _VLM_PROMPTS[:6]] + [(160, 448), (1, 145)],
                T=2048, kv_decode=(8, 8), kv_prefill=(2048, 1601), budget=2048),
    # 32 decoding sequences at kv 129-253; one 2048-token budget of 15 whole
    # prompts, a chunk and 16 decodes (2048 latent rows, none padded)
    "mla": dict(arch=MLA_ARCH,
                decode=[(1, 129 + 4 * s) for s in range(32)],
                mixed=[(128, 128)] * 15 + [(112, 112)] + [(1, 129 + 8 * i) for i in range(16)],
                T=2048, kv_decode=(32, 32), kv_prefill=(2048, 2048), gemm_m=32,
                budget=2048),
}
# the image prompts of the llavanext and internvl phases: MM_TEXT
# characters and the image's tokens; the mixed batches are steps of the
# 2048-token budget: the rest of a prompt whose first chunk filled a step,
# the next prompts, and decodes
_NEXT_PROMPTS = [MM_TEXT + n for n in (2928, 2340, 1752, 2376)] * 2
_INTERNVL_PROMPTS = [MM_TEXT + n for n in (256, 768, 1792, 3328)] * 2
# K4 at these two paths: the decode step's M and the budget only (the
# kernels line's two sums; the M sweep runs at serve, vlm and mla)
PATH_SHAPES["next13b"] = dict(
    arch=NEXT_ARCH, decode=[(1, n + 16) for n in _NEXT_PROMPTS],
    mixed=[(912, 2960), (1121, 1121), (1, 1800), (1, 2424)], T=2048, kv_decode=(8, 8),
    kv_prefill=(2048, 2035), budget=2048, gemm_sweep=(16, 2048))
PATH_SHAPES["internvl"] = dict(
    arch="internlm2-7b", decode=[(1, n + 16) for n in _INTERNVL_PROMPTS],
    mixed=[(288, 288), (800, 800), (945, 3360), (1, 304), (1, 816)], T=2048,
    kv_decode=(8, 8), kv_prefill=(2048, 2035), budget=2048, gemm_sweep=(16, 2048))
# the deepseek phase's batches are the mla path's (V2-Lite's attention has
# mla-2b-lm's geometry); vl2: decodes at 16 tokens in, and a 2048-token
# budget of two image prompts, the first chunk of a third and 2 decodes. K4
# at these paths: the decode step's M and the budget only
PATH_SHAPES["deepseek"] = dict(PATH_SHAPES["mla"], arch="deepseek-v2-lite",
                               gemm_sweep=(32, 2048))
_VL2_PROMPTS = [MM_TEXT + n for n in (421, 1023, 813, 631)] * 2
PATH_SHAPES["vl2"] = dict(
    arch="deepseek-vl2-tiny-lm", decode=[(1, n + 16) for n in _VL2_PROMPTS],
    mixed=[(453, 453), (1055, 1055), (536, 845), (1, 469), (1, 679)], T=2048,
    kv_decode=(8, 8), kv_prefill=(2048, 2046), budget=2048, gemm_sweep=(16, 2048))
# mixtral: 32 decoding sequences at kv 144-206, and one 2048-token budget of
# 16 whole prompts; gpt2: the same batches over GPT-2 XL's bf16 cache (kv:
# the cache's dtype; no int8 matmul, so no K4)
PATH_SHAPES["mixtral"] = dict(
    arch="mixtral-8x7b", decode=[(1, 144 + 2 * s) for s in range(32)],
    mixed=[(128, 128)] * 16, T=2048, kv_decode=(32, 32), kv_prefill=(2048, 2048), gemm_m=32,
    budget=2048, gemm_sweep=(32, 2048))
PATH_SHAPES["gpt2"] = dict(PATH_SHAPES["mixtral"], arch="gpt2-xl", kv="bf16")
# the tp phase's shard shapes: llava-7b-lm at tp 2 (16 q / 16 kv heads x d128,
# K4 at qkv 4096 x 6144, o 2048 x 4096, gate_up 4096 x 11008, down 5504 x
# 4096, lm_head 4096 x 16000) over the serve phase's batches, its decode step
# at M 8; V2-Lite at tp 2 (8 heads over the 576-wide plane; K4 at o 1024 x
# 2048, the dense layer 2048 x 10944 and 5472 x 2048, the shared experts
# 2048 x 2816 and 1408 x 2048, lm_head 2048 x 51200): 8 decoding sequences
# and one 1024-token budget of the 8 prompts
PATH_SHAPES["tp"] = dict(PATH_SHAPES["serve"], arch="llava-7b-lm-tp2", gemm_m=8,
                         gemm_sweep=(8, TP_BUDGET))
PATH_SHAPES["tp_mla"] = dict(
    arch="deepseek-v2-lite-tp2", decode=[(1, 129 + 4 * s) for s in range(TP_REQUESTS)],
    mixed=[(TP_PROMPT, TP_PROMPT)] * TP_REQUESTS, T=TP_MLA_BUDGET,
    kv_decode=(TP_REQUESTS, TP_REQUESTS), kv_prefill=(TP_MLA_BUDGET, TP_MLA_BUDGET),
    gemm_m=TP_REQUESTS, budget=TP_MLA_BUDGET, gemm_sweep=(TP_REQUESTS, TP_MLA_BUDGET))
# the pp phase's microbatch shapes: llava-7b-lm's decode step at pp 2 runs 2
# microbatches of 4 sequences (K1 over 4 sequences, K3 4 rows, K4 at M 4;
# the head's lm_head at M 8), its relay steps the serve phase's batches
PATH_SHAPES["pp"] = dict(PATH_SHAPES["serve"],
                         decode=[(1, 130 + 7 * s) for s in range(TP_REQUESTS // PP_SIZE)],
                         kv_decode=(TP_REQUESTS // PP_SIZE,) * 2,
                         gemm_m=TP_REQUESTS // PP_SIZE, gemm_sweep=(TP_REQUESTS // PP_SIZE,
                                                                    TP_BUDGET))
# the speculative verify step of the spec phase (llava-7b-lm, S floor 8,
# K1 = 13): 8 segments of 13 rows padded to T = 128 (max_q 16) through K2,
# and every int8 projection, lm_head included, at M = T through K4
VERIFY_SHAPES = dict(arch="llava-7b-lm", K1=13,
                     mixed=[(13, 181 + 7 * s) for s in range(8)], T=128)
# the quality phase's all-position prefill (llava-7b-lm, one 512-token
# sequence over the bf16 cache of the bf16 baseline) through K2, and the
# lm_head at every position (M = 512, f32 out) through K4's three forms
QUALITY_SHAPES = dict(arch=QUALITY_ARCH, kv="bf16", mixed=[(QUALITY_FULL_T, QUALITY_FULL_T)],
                      T=QUALITY_FULL_T)


def _shapes(path: str) -> dict:
    return {"spec": VERIFY_SHAPES, "quality": QUALITY_SHAPES}.get(path) or PATH_SHAPES[path]


def _arch_name(path: str) -> str:
    return _shapes(path)["arch"]


def _arch_cfg(path: str):
    from hydrainfer_tpu_torch.models.random_init import ARCH_CONFIGS
    name = _arch_name(path)
    return LOCAL_ARCHS[name]() if name in LOCAL_ARCHS else ARCH_CONFIGS[name]


def _is_mla(cfg) -> bool:
    """Whether a model's cache is the single-plane latent one (GPT-2's
    config, which has no MLA fields, is multi-head)."""
    return bool(getattr(cfg, "mla_kv_lora", 0))


def _runs_k4(path: str) -> bool:
    """Whether the path runs int8 matmuls (K4): every path but gpt2's bf16."""
    return PATH_SHAPES[path].get("kv") != "bf16"


def _int8_shapes(path: str) -> dict:
    """{name: (K, N)} of the path's int8 matmuls: int8_matmul_shapes (a MoE
    model's gate_up and down there are its dense layer's), and a MoE
    model's shared experts."""
    from hydrainfer_tpu_torch.models.random_init import int8_matmul_shapes
    cfg = _arch_cfg(path)
    shapes = int8_matmul_shapes(cfg)
    text = MOE_TEXT.get(_arch_name(path))
    if text is not None:
        head = shapes.pop("lm_head")
        n = text["moe_intermediate_size"] * text["n_shared_experts"]
        shapes.update({"shared_gate_up": (text["hidden_size"], 2 * n),
                       "shared_down": (n, text["hidden_size"]), "lm_head": head})
    elif cfg.moe_top_k:
        # every MLP is the routed experts (bf16, the grouped product): Mixtral
        del shapes["gate_up"], shapes["down"]
    return shapes


def _kv_scale(path: str):
    """The KV scale of a path's cache: 0.05 over int8, None over the bf16
    cache of a path whose PATH_SHAPES entry says kv="bf16"."""
    return None if _shapes(path).get("kv") == "bf16" else 0.05


def _kv_what(kv_scale) -> str:
    return "bf16 KV" if kv_scale is None else "int8 KV"


def _pool_blocks(specs, bs: int) -> int:
    """Blocks a page pool needs for the sequences [(q_len, kv_len), ...]
    with _paged_case's table layout (block 0 left out), 512 at least."""
    mb = max(-(-kv // bs) for _, kv in specs)
    return max(512, len(specs) * mb + 1)


def _paged_case(gen, seq_specs, n_blocks, bs, kvh, d, kv_scale, dev):
    """An int8 page pool (bf16 where kv_scale is None) holding each
    sequence's kv_len tokens, plus the flattened query geometry of seq_specs
    = [(q_len, kv_len), ...]."""
    import torch
    S = len(seq_specs)
    pages = torch.zeros((n_blocks, bs, 2 * kvh, d),
                        dtype=torch.int8 if kv_scale is not None else torch.bfloat16,
                        device=dev)
    mb = max(-(-kv // bs) for _, kv in seq_specs)
    tables = torch.full((S, mb), -1, dtype=torch.int32)
    perm = torch.randperm(n_blocks - 1, generator=gen)[: S * mb] + 1
    for s, (_, kv) in enumerate(seq_specs):
        nb = -(-kv // bs)
        tables[s, :nb] = perm[s * mb: s * mb + nb].to(torch.int32)
    vals = torch.randn((n_blocks, bs, 2 * kvh, d), generator=gen)
    pages.copy_(vals if kv_scale is None else
                torch.clamp(torch.round(vals / kv_scale), -127, 127).to(torch.int8))
    kv_lens = torch.tensor([kv for _, kv in seq_specs], dtype=torch.int32)
    cu = [0]
    for q, _ in seq_specs:
        cu.append(cu[-1] + q)
    return (pages, tables.to(dev), kv_lens.to(dev),
            torch.tensor(cu, dtype=torch.int32, device=dev),
            torch.tensor([S], dtype=torch.int32, device=dev))


def check_quant_matmul(gen, dev, path, m_values=None) -> dict:
    """K4 at every int8 projection of the path (and its lm_head, f32 out),
    over an M sweep across the skinny/wide boundary: held to the plain
    version, timed eager and from a CUDA graph over rotating weight copies
    (so no launch finds its weight in L2), beside its bound and the fastest
    library form: torch._weight_int8pack_mm (M <= 64 only: far the slowest
    above), or torch.mm on the weight dequantized to bf16 outside the timed
    call (rotated the same way), each held to the plain version first. The kernels line sums one decode step
    (M = the decode batch) and one prefill budget (qkv, o, gate_up, down at
    M = the path's token budget; the lm_head sees only the sampled rows).
    `m_values`: the M values to check instead of the sweep (the verify
    step's T: its kernels line sums every projection, lm_head included, at
    that M)."""
    import torch
    from hydrainfer_tpu_torch.ops.cuda.quant_matmul import (SKINNY_MAX_M, plan,
                                                            quant_matmul_int8,
                                                            quant_matmul_int8_plain)
    if m_values is not None:
        m_row = m_prefill = m_values[0]
    else:
        m_row = PATH_SHAPES[path].get("gemm_m", 16)
        m_prefill = PATH_SHAPES[path]["budget"]
    projections = _int8_shapes(path)
    rows, max_err, ok = [], 0.0, True
    for name, (K, N) in projections.items():
        out_dtype = torch.float32 if name == "lm_head" else torch.bfloat16
        w = torch.randint(-127, 128, (K, N), generator=gen, dtype=torch.int8).to(dev)
        scale = (torch.rand(N, generator=gen) + 0.5).div(127 * math.sqrt(K)).to(dev)
        # rotate weight copies so repeated launches do not find w in L2
        n_copies = max(1, math.ceil(120e6 / (K * N)))
        ws = [w] + [w.clone() for _ in range(n_copies - 1)]
        w_bf = (w.float() * scale[None, :]).to(torch.bfloat16)
        n_bf = max(1, math.ceil(120e6 / (2 * K * N)))
        w_bfs = [w_bf] + [w_bf.clone() for _ in range(n_bf - 1)]
        w_t, sc_bf = w.t().contiguous(), scale.to(torch.bfloat16)
        for M in (m_values or PATH_SHAPES[path].get("gemm_sweep")
                  or sorted({1, 16, 48, 256, 2048, m_row, m_prefill})):
            x = torch.randn((M, K), generator=gen).to(dev, torch.bfloat16)
            got = quant_matmul_int8(x, w, scale, out_dtype)
            ref = quant_matmul_int8_plain(x, w, scale, out_dtype)
            err = (got.float() - ref.float()).abs().max().item()
            # bf16 output rounding (2^-9 relative) and f32 sum order
            scale_ref = max(1.0, ref.float().abs().max().item())
            tol = (1e-2 if out_dtype == torch.bfloat16 else 1e-4) * scale_ref
            ok &= err <= tol
            max_err = max(max_err, err)

            def rotating(copies, fn):
                it = iter(range(10 ** 9))
                return lambda: fn(copies[next(it) % len(copies)])

            kernel = rotating(ws, lambda wq: quant_matmul_int8(x, wq, scale, out_dtype))
            ms = time_ms(kernel)
            # K4's graph time where the kernels line reads it (the decode step
            # and the prefill budget, not the lm_head at prefill M)
            timed_graph = M == m_row or (M == m_prefill and name != "lm_head")
            plain_ms = time_ms(lambda: quant_matmul_int8_plain(x, w, scale, out_dtype),
                               iters=5)
            # the library forms put out bf16: held within bf16 rounding.
            # torch._weight_int8pack_mm only up to the skinny form's M: above
            # it, it takes 2-1700 ms a call (seconds of the time limit a row)
            # where torch.mm takes under 1
            forms = {"torch.mm, weight dequantized to bf16 outside the timed call": (
                lambda: rotating(w_bfs, lambda wb: torch.mm(x, wb)), lambda o: o)}
            if M <= SKINNY_MAX_M:
                forms["torch._weight_int8pack_mm"] = (
                    lambda: lambda: torch._weight_int8pack_mm(x, w_t, sc_bf), lambda o: o)
            library, lib = _fastest(forms, ref, 1e-2 * scale_ref)
            out_bytes = torch.empty((), dtype=out_dtype).element_size()
            b_ms, b_by = bound_ms(M * K * 2 + K * N + N * 4 + M * N * out_bytes,
                                  2.0 * M * K * N)
            p = plan(M, K, N)
            rows.append({"proj": name, "M": M, "K": K, "N": N, "form": p.form, "bn": p.bn,
                         "splits": p.splits, "max_abs_err": err, "tol": tol, "ms": ms,
                         "graph_ms": graph_ms(kernel) if timed_graph else None,
                         "plain_ms": plain_ms,
                         "library_ms": library[lib]["ms"] if lib else None,
                         "library_graph_ms": library[lib].get("graph_ms") if lib else None,
                         "library": lib, "library_forms": library,
                         "bound_ms": b_ms, "bound_by": b_by})
        del ws, w_bfs, w_t
    save(f"quant_matmul_{path}.json", rows)

    def total(sel, key):
        vals = [r[key] for r in sel]
        return sum(vals) if all(v is not None for v in vals) else None

    # the kernels line: one decode step's int8 projections at M = m_row, and
    # one prefill budget's layer projections at M = m_prefill
    step = [r for r in rows if r["M"] == m_row]
    pre = [r for r in rows if r["M"] == m_prefill and r["proj"] != "lm_head"]
    head = next(r for r in step if r["proj"] == "lm_head")
    return {"name": "quant_matmul", "path": path, "ok": bool(ok), "max_abs_err": max_err,
            "tolerance": "1e-2 x max|plain| (bf16 out), 1e-4 x max|plain| (f32 logits)",
            "shape": f"{_arch_name(path)}: " + ", ".join(
                f"{n} {k}x{n_}" for n, (k, n_) in projections.items())
                     + f" (lm_head f32 out) at M={m_row}, summed"
                     + ("" if m_values else f"; prefill: the layer projections at "
                                            f"M={m_prefill}, summed"),
            "ms": total(step, "ms"), "graph_ms": total(step, "graph_ms"),
            "plain_ms": total(step, "plain_ms"), "bound_ms": total(step, "bound_ms"),
            "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in step)
            else "operations",
            "library_ms": total(step, "library_ms"),
            "library_graph_ms": total(step, "library_graph_ms"),
            "library": "the fastest per projection of torch._weight_int8pack_mm and "
                       "torch.mm on the weight dequantized to bf16 outside the timed call",
            "prefill_ms": total(pre, "ms"), "prefill_graph_ms": total(pre, "graph_ms"),
            "prefill_bound_ms": total(pre, "bound_ms"),
            "prefill_library_ms": total(pre, "library_ms"),
            "prefill_library_graph_ms": total(pre, "library_graph_ms"),
            # the lm_head alone at M = m_row (its N is the vocabulary: an odd N
            # leaves no int8 weight row 16-byte aligned)
            "lm_head_n": head["N"], "lm_head_ms": head["ms"],
            "lm_head_graph_ms": head["graph_ms"], "lm_head_bound_ms": head["bound_ms"],
            "lm_head_library_ms": head["library_ms"],
            "lm_head_library_graph_ms": head["library_graph_ms"]}


def check_quant_forms(gen, dev, mode: str) -> dict:
    """K4's int4 (g = 128) or fp8 form at llava-7b-lm's four layer
    projections (and, at fp8, its lm_head, f32 out), the weights N(0, 1/K)
    quantized on the card by the port's quantize_tree function for the mode:
    each held to its plain version (JAX's arithmetic) at serve's decode step
    (M 16) and prefill budget (M 256), then timed eager and from a CUDA graph
    over rotating weight copies (no launch finds its weight in L2), beside
    its byte or operation bound (the stored bytes: int4's packed values and
    f32 group scales) and torch.mm on the weight dequantized to bf16 outside
    the timed call. The kernels line sums the four projections at M 16 and,
    as prefill_*, at M 256."""
    import torch
    from hydrainfer_tpu_torch.models.random_init import (ARCH_CONFIGS, quant_matmul_forms,
                                                         quant_weight_bytes)
    from hydrainfer_tpu_torch.ops.cuda import quant_matmul as qmm
    from hydrainfer_tpu_torch.ops.quant import _fmt, dequantize, quantize_fp8, quantize_int4
    quant = {"int4": quantize_int4, "fp8": quantize_fp8}[mode]
    kernel = {"int4": qmm.quant_matmul_int4, "fp8": qmm.quant_matmul_fp8}[mode]
    plain = {"int4": qmm.quant_matmul_int4_plain, "fp8": qmm.quant_matmul_fp8_plain}[mode]
    m_step, m_prefill = 16, PATH_SHAPES["serve"]["budget"]
    forms = {name: f for name, f in quant_matmul_forms(ARCH_CONFIGS[QUANT_ARCH], mode).items()
             if f[2] == mode}
    rows, max_err, ok = [], 0.0, True
    for name, (K, N, fmt, group) in forms.items():
        out_dtype = torch.float32 if name == "lm_head" else torch.bfloat16
        w = (torch.randn((K, N), generator=gen) / math.sqrt(K)).to(dev)
        qt = quant(w)
        del w
        assert _fmt(qt) == fmt and qt.group == group, (name, qt.group, group)
        w_bytes = quant_weight_bytes(K, N, fmt, group)
        n_copies = max(1, math.ceil(120e6 / w_bytes))
        qs = [qt.q] + [qt.q.clone() for _ in range(n_copies - 1)]
        w_bf = dequantize(qt, torch.bfloat16)
        n_bf = max(1, math.ceil(120e6 / (2 * K * N)))
        w_bfs = [w_bf] + [w_bf.clone() for _ in range(n_bf - 1)]
        for M in (m_step, m_prefill) if name != "lm_head" else (m_step,):
            x = torch.randn((M, K), generator=gen).to(dev, torch.bfloat16)
            got = kernel(x, qt.q, qt.scale, qt.group, out_dtype)
            ref = plain(x, qt.q, qt.scale, qt.group, torch.float32)
            err = (got.float() - ref).abs().max().item()
            scale_ref = max(1.0, ref.abs().max().item())
            tol = (1e-2 if out_dtype == torch.bfloat16 else 1e-4) * scale_ref
            ok &= err <= tol
            max_err = max(max_err, err)

            def rotating(copies, fn):
                it = iter(range(10 ** 9))
                return lambda: fn(copies[next(it) % len(copies)])

            call = rotating(qs, lambda q: kernel(x, q, qt.scale, qt.group, out_dtype))
            library, lib = _fastest({
                "torch.mm, weight dequantized to bf16 outside the timed call": (
                    lambda: rotating(w_bfs, lambda wb: torch.mm(x, wb)), lambda o: o)},
                ref, 1e-2 * scale_ref)
            out_bytes = 4 if out_dtype == torch.float32 else 2
            b_ms, b_by = bound_ms(M * K * 2 + w_bytes + M * N * out_bytes, 2.0 * M * K * N)
            p = qmm.plan(M, K, N, fmt)
            rows.append({"proj": name, "M": M, "K": K, "N": N, "fmt": fmt, "group": group,
                         "weight_bytes": w_bytes, "form": p.form, "bn": p.bn,
                         "splits": p.splits, "max_abs_err": err, "tol": tol,
                         "ms": time_ms(call), "graph_ms": graph_ms(call),
                         "plain_ms": time_ms(lambda: plain(x, qt.q, qt.scale, qt.group,
                                                           out_dtype), iters=5),
                         "library_ms": library[lib]["ms"] if lib else None,
                         "library_graph_ms": library[lib].get("graph_ms") if lib else None,
                         "library": lib, "library_forms": library,
                         "bound_ms": b_ms, "bound_by": b_by})
        del qs, w_bfs, qt
    save(f"quant_matmul_{mode}.json", rows)

    def total(sel, key):
        vals = [r[key] for r in sel]
        return sum(vals) if all(v is not None for v in vals) else None

    step = [r for r in rows if r["M"] == m_step and r["proj"] != "lm_head"]
    pre = [r for r in rows if r["M"] == m_prefill]
    head = [r for r in rows if r["proj"] == "lm_head"]
    layer = ", ".join(f"{r['proj']} {r['K']}x{r['N']} g{r['group']}" for r in step)
    row = {"name": f"quant_matmul_{mode}", "path": f"quant_{mode}", "ok": bool(ok),
           "max_abs_err": max_err,
           "tolerance": "1e-2 x max|plain| (bf16 out), 1e-4 x max|plain| (f32 logits)",
           "shape": f"{QUANT_ARCH} at {mode}: {layer}, summed at M={m_step}; prefill: at "
                    f"M={m_prefill}" + (", lm_head (f32 out) alone as lm_head_*" if head
                                        else "; its lm_head is int8 (K4's int8 form)"),
           "ms": total(step, "ms"), "graph_ms": total(step, "graph_ms"),
           "plain_ms": total(step, "plain_ms"), "bound_ms": total(step, "bound_ms"),
           "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in step)
           else "operations",
           "library_ms": total(step, "library_ms"),
           "library_graph_ms": total(step, "library_graph_ms"),
           "library": "torch.mm on the weight dequantized to bf16 outside the timed call",
           "prefill_ms": total(pre, "ms"), "prefill_graph_ms": total(pre, "graph_ms"),
           "prefill_bound_ms": total(pre, "bound_ms"),
           "prefill_library_ms": total(pre, "library_ms"),
           "prefill_library_graph_ms": total(pre, "library_graph_ms")}
    if head:
        h = head[0]
        row.update({"lm_head_n": h["N"], "lm_head_ms": h["ms"], "lm_head_graph_ms": h["graph_ms"],
                    "lm_head_bound_ms": h["bound_ms"], "lm_head_library_ms": h["library_ms"],
                    "lm_head_library_graph_ms": h["library_graph_ms"]})
    return row


def check_attention(gen, dev, path) -> list:
    import torch
    import torch.nn.functional as F
    from hydrainfer_tpu_torch.ops.cuda.mha_decode import (
        mha_decode_attention, mha_decode_attention_plain)
    from hydrainfer_tpu_torch.ops.cuda.paged_attention import (
        paged_attention_varlen, paged_attention_varlen_plain)
    cfg, shp = _arch_cfg(path), PATH_SHAPES[path]
    H, kvh, D, bs, kv_scale = cfg.n_qo_heads, cfg.n_kv_heads, cfg.head_dim, 16, _kv_scale(path)
    sm = 1.0 / math.sqrt(D)
    heads = f"{H} q / {kvh} kv heads x d{D}, {_kv_what(kv_scale)}, BS 16"
    dense_kv = lambda pages, tables, kv_lens: _dense_kv(pages, tables, kv_lens, H, kvh, D,
                                                       kv_scale)
    out = []
    # K1: a decode window of 8 sequences
    specs = shp["decode"]
    S = len(specs)
    pages, tables, kv_lens, _, ns = _paged_case(gen, specs, _pool_blocks(specs, bs), bs,
                                                kvh, D, kv_scale, dev)
    q = torch.randn((S, H, D), generator=gen).to(dev, torch.bfloat16)
    got = mha_decode_attention(q, pages, kv_lens, tables, ns, sm, kv_scale)
    ref = mha_decode_attention_plain(q, pages, kv_lens, tables, ns, sm, kv_scale)
    err = (got.float() - ref.float()).abs().max().item()
    ks, vs = dense_kv(pages, tables, kv_lens)
    L = max(k.shape[1] for k in ks)
    kd = torch.zeros((S, H, L, D), dtype=torch.bfloat16, device=dev)
    vd = torch.zeros_like(kd)
    mask = torch.zeros((S, 1, 1, L), dtype=torch.bool, device=dev)
    for s in range(S):
        n = ks[s].shape[1]
        kd[s, :, :n], vd[s, :, :n] = ks[s], vs[s]
        mask[s, ..., :n] = True
    qd = q[:, :, None, :]
    n_kv = int(kv_lens.sum())
    b_ms, b_by = bound_ms(q.numel() * 2 * 2 + n_kv * 2 * kvh * D * pages.element_size()
                          + S * 4 * (1 + tables.shape[1]), 4.0 * H * D * n_kv)
    # the varlen forms over the same gathered K/V: one query row a sequence,
    # (sum kv, KVH, D) for flash (GQA in the call), repeated over the query
    # heads for the memory-efficient form; no mask (a decode row sees all)
    k_flat = torch.cat([k[::H // kvh].transpose(0, 1) for k in ks]).contiguous()
    v_flat = torch.cat([v[::H // kvh].transpose(0, 1) for v in vs]).contiguous()
    k_rep, v_rep = (torch.cat([x.transpose(0, 1) for x in xs]).contiguous()[None]
                    for xs in (ks, vs))
    cu_q = torch.arange(S + 1, dtype=torch.int32, device=dev)
    cu_k = torch.tensor([0] + [kvl for _, kvl in specs], device=dev).cumsum(0).int()
    library, lib = _fastest({
        "SDPA, dense K/V and bool mask": (
            lambda: lambda: F.scaled_dot_product_attention(qd, kd, vd, attn_mask=mask),
            lambda o: o[:, :, 0]),
        "aten._flash_attention_forward, varlen, q_len 1 (GQA)": (
            lambda: lambda: torch.ops.aten._flash_attention_forward(
                q, k_flat, v_flat, cu_q, cu_k, 1, L, 0.0, False, False, scale=sm)[0],
            lambda o: o),
        "aten._efficient_attention_forward, varlen": (
            lambda: lambda: torch.ops.aten._efficient_attention_forward(
                q[None], k_rep, v_rep, None, cu_q, cu_k, 1, L, 0.0, 0, False,
                scale=sm)[0],
            lambda o: o[0]),
    }, ref, 3e-2)
    save(f"mha_decode_{path}.json", {"specs": specs, "err": err, "library": library})
    kernel = lambda: mha_decode_attention(q, pages, kv_lens, tables, ns, sm, kv_scale)
    out.append({"name": "mha_decode", "path": path, "ok": err <= 3e-2, "max_abs_err": err,
                "tolerance": "3e-2 abs (bf16 K/V rounding in the plain version)",
                "shape": f"{S} seqs, kv {min(kv for _, kv in specs)}.."
                         f"{max(kv for _, kv in specs)}, {heads}",
                "ms": time_ms(kernel), "graph_ms": graph_ms(kernel),
                "plain_ms": time_ms(lambda: mha_decode_attention_plain(
                    q, pages, kv_lens, tables, ns, sm, kv_scale), iters=5),
                "library_ms": library[lib]["ms"] if lib else None,
                "library_graph_ms": library[lib].get("graph_ms") if lib else None,
                "library": f"{lib}; K/V gathered and dequantized outside the timed call"
                           if lib else None,
                "library_forms_ms": {n: r.get("ms") for n, r in library.items()},
                "bound_ms": b_ms, "bound_by": b_by})

    # K2: a mixed batch: prefill chunks, a chunked continuation, decodes
    out.append(check_paged_mixed(gen, dev, path, shp["mixed"], shp["T"],
                                 "prefills, a chunked continuation, decodes"))
    return out


def _dense_kv(pages, tables, kv_lens, H, kvh, D, kv_scale):
    """K/V of each sequence gathered dense, dequantized (bf16; a bf16 cache,
    kv_scale None, as it is) and repeated over each kv head's query heads:
    (H, n, D) each."""
    import torch
    ks, vs = [], []
    for s in range(tables.shape[0]):
        n = int(kv_lens[s])
        rows = pages[tables[s].clamp(min=0).long()].reshape(-1, 2 * kvh, D)[:n]
        for plane, out in ((rows[:, 0::2], ks), (rows[:, 1::2], vs)):
            out.append((plane.float() * (1.0 if kv_scale is None else kv_scale))
                       .to(torch.bfloat16)
                       .transpose(0, 1).repeat_interleave(H // kvh, 0))
    return ks, vs


def check_paged_mixed(gen, dev, path, specs, T, what) -> dict:
    """K2 over the batch specs = [(q_len, kv_len), ...] padded to T rows:
    held to the plain version (padding rows zero), timed eager and from a
    CUDA graph beside its bound and the fastest library form."""
    import torch
    import torch.nn.functional as F
    from hydrainfer_tpu_torch.ops.cuda.paged_attention import (
        paged_attention_varlen, paged_attention_varlen_plain)
    cfg = _arch_cfg(path)
    H, kvh, D, bs, kv_scale = cfg.n_qo_heads, cfg.n_kv_heads, cfg.head_dim, 16, _kv_scale(path)
    sm = 1.0 / math.sqrt(D)
    heads = f"{H} q / {kvh} kv heads x d{D}, {_kv_what(kv_scale)}, BS 16"
    pages, tables, kv_lens, cu, ns = _paged_case(gen, specs, _pool_blocks(specs, bs), bs,
                                                 kvh, D, kv_scale, dev)
    T_real = int(cu[-1])
    q = torch.randn((T, H, D), generator=gen).to(dev, torch.bfloat16)
    got = paged_attention_varlen(q, pages, kv_lens, tables, cu, ns, sm, kv_scale)
    ref = paged_attention_varlen_plain(q, pages, kv_lens, tables, cu, ns, sm, kv_scale)
    err = (got.float() - ref.float()).abs().max().item()
    pad_zero = bool((got[T_real:] == 0).all())
    ks, vs = _dense_kv(pages, tables, kv_lens, H, kvh, D, kv_scale)
    kcat, vcat = torch.cat(ks, 1)[None], torch.cat(vs, 1)[None]
    amask = torch.zeros((T_real, kcat.shape[2]), dtype=torch.bool)
    visible = 0
    t0, c0 = 0, 0
    for (ql, kv) in specs:
        for i in range(ql):
            n = kv - ql + i + 1
            amask[t0 + i, c0:c0 + n] = True
            visible += n
        t0, c0 = t0 + ql, c0 + kv
    amask = amask.to(dev)
    qv = q[:T_real].transpose(0, 1)[None]
    q_flat = q[:T_real]
    # the varlen forms: each sequence's K/V rows side by side, (sum kv, KVH, D)
    # for flash (GQA in the call), repeated over the query heads for the
    # memory-efficient form; bottom-right causal masks, as K2's
    k_flat = kcat[0, ::H // kvh].transpose(0, 1).contiguous()
    v_flat = vcat[0, ::H // kvh].transpose(0, 1).contiguous()
    k_rep, v_rep = (x[0].transpose(0, 1).contiguous()[None] for x in (kcat, vcat))
    cu_q = cu[:len(specs) + 1]
    cu_k = torch.tensor([0] + [kvl for _, kvl in specs], device=dev).cumsum(0).int()
    max_q, max_k = max(ql for ql, _ in specs), max(kvl for _, kvl in specs)
    library, lib = _fastest({
        "SDPA, dense bool mask over all sequences' pairs": (
            lambda: lambda: F.scaled_dot_product_attention(qv, kcat, vcat, attn_mask=amask),
            lambda o: o[0].transpose(0, 1)),
        "aten._flash_attention_forward, varlen, causal (GQA)": (
            lambda: lambda: torch.ops.aten._flash_attention_forward(
                q_flat, k_flat, v_flat, cu_q, cu_k, max_q, max_k, 0.0, True, False,
                scale=sm)[0],
            lambda o: o),
        "aten._efficient_attention_forward, varlen, bottom-right causal": (
            lambda: lambda: torch.ops.aten._efficient_attention_forward(
                q_flat[None], k_rep, v_rep, None, cu_q, cu_k, max_q, max_k, 0.0, 2, False,
                scale=sm)[0],
            lambda o: o[0]),
    }, ref[:T_real], 3e-2)
    save(f"paged_attention_{path}.json", {"specs": specs, "err": err,
                                          "padding_rows_zero": pad_zero,
                                          "library": library})
    n_kv = int(kv_lens.sum())
    b_ms, b_by = bound_ms(T_real * H * D * 2 * 2 + n_kv * 2 * kvh * D * pages.element_size(),
                          4.0 * H * D * visible)
    kernel = lambda: paged_attention_varlen(q, pages, kv_lens, tables, cu, ns, sm, kv_scale)
    return {"name": "paged_attention", "path": path, "ok": err <= 3e-2 and pad_zero,
            "max_abs_err": err,
            "tolerance": "3e-2 abs (bf16 K/V rounding in the plain version)",
            "shape": f"{T_real} tokens (T={T}) in {len(specs)} seqs: {what}; {heads}",
            "ms": time_ms(kernel),
            "graph_ms": graph_ms(kernel),
            "plain_ms": time_ms(lambda: paged_attention_varlen_plain(
                q, pages, kv_lens, tables, cu, ns, sm, kv_scale), iters=5),
            "library_ms": library[lib]["ms"] if lib else None,
            "library_graph_ms": library[lib].get("graph_ms") if lib else None,
            "library": f"{lib}; K/V gathered and dequantized outside the timed call"
                       if lib else None,
            "library_forms_ms": {n: r.get("ms") for n, r in library.items()},
            "bound_ms": b_ms, "bound_by": b_by}


def _library_ms(fn) -> float:
    """time_ms over as many calls as fit in about 0.25 s, 3 to 20: a library
    form far slower than the kernel beside it (torch._weight_int8pack_mm
    takes 0.1-1.7 s a call at M = 2048) is timed over fewer calls."""
    once = time_ms(fn, iters=1, warmup=1)
    return time_ms(fn, iters=max(3, min(20, int(250 / max(once, 1e-3)))), warmup=0)


def _fastest(calls: dict, ref, tol: float):
    """Library yardsticks: {name: (make the call, its output in ref's
    layout)}. Each is held to the plain version's `ref` first (max abs error
    within tol) and timed only if it agrees; a call this torch build refuses
    is recorded as such. The fastest is also timed from a CUDA graph
    (graph_ms). Returns ({name: {"err", "ms"} or {"error"}}, the fastest name
    or None)."""
    library, fns = {}, {}
    for name, (make, flat) in calls.items():
        try:
            fns[name] = make()
            err = (flat(fns[name]()).float() - ref.float()).abs().max().item()
            library[name] = {"err": err, "ms": _library_ms(fns[name]) if err <= tol else None}
        except Exception as e:          # not in this torch build: say so
            library[name] = {"error": repr(e)[:200]}
    timed = {n: r["ms"] for n, r in library.items() if r.get("ms") is not None}
    if not timed:
        return library, None
    lib = min(timed, key=timed.get)
    try:
        library[lib]["graph_ms"] = graph_ms(fns[lib])
    except Exception as e:              # a call that cannot be captured
        library[lib]["graph_error"] = repr(e)[:200]
    return library, lib


def _latent_case(gen, seq_specs, n_blocks, bs, d, kv_scale, dev):
    """An int8 single-plane pool (n_blocks, bs, 1, d) holding each sequence's
    kv_len latent rows, plus the flattened query geometry."""
    import torch
    S = len(seq_specs)
    mb = max(-(-kv // bs) for _, kv in seq_specs)
    tables = torch.zeros((S, mb), dtype=torch.int32)
    perm = torch.randperm(n_blocks - 1, generator=gen)[: S * mb] + 1
    for s, (_, kv) in enumerate(seq_specs):
        n = -(-kv // bs)
        tables[s, :n] = perm[s * mb: s * mb + n].to(torch.int32)
    vals = torch.randn((n_blocks, bs, 1, d), generator=gen)
    pages = torch.clamp(torch.round(vals / kv_scale), -127, 127).to(torch.int8).to(dev)
    cu = [0]
    for q, _ in seq_specs:
        cu.append(cu[-1] + q)
    i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=dev)
    return (pages, tables.to(dev), i32([kv for _, kv in seq_specs]), i32(cu), i32([S]))


def _sdpa_calls(q, kv, mask, scale) -> dict:
    """One SDPA call over the gathered dense plane with K = V, under each
    backend in turn and in two MQA forms (enable_gqa over the one plane, or
    the plane expanded over the heads without a copy), as `_fastest` takes
    them (output in SDPA's (B, H, L, D) layout). Flash attention takes no
    mask and no D above 256, so it is expected to refuse."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    H = q.shape[1]
    wide = kv.expand(kv.shape[0], H, *kv.shape[2:])
    forms = {"gqa": lambda: F.scaled_dot_product_attention(
                 q, kv, kv, attn_mask=mask, scale=scale, enable_gqa=True),
             "expand": lambda: F.scaled_dot_product_attention(
                 q, wide, wide, attn_mask=mask, scale=scale)}
    calls = {}
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        for form, fn in forms.items():
            def make(backend=backend, fn=fn):
                def call():
                    with sdpa_kernel(backend):
                        return fn()
                return call
            calls[f"SDPA {backend.name.lower()}/{form}"] = make
    return calls


def check_latent(gen, dev, path="mla") -> list:
    """K6 on an MLA path (mla; deepseek, at V2-Lite's YaRN softmax scale): a
    decode window of 32 sequences (kv 129-253, the split-KV decode form,
    max_q = 1) and one mixed 2048-token batch (the 64-row form), each with
    bf16 queries (the serving form) and f32 queries, over an int8 plane of
    16 heads x 576. The bf16 form is held against the plain version run in
    f32 on the same inputs, the f32 form against the plain version as it
    is."""
    import torch
    from hydrainfer_tpu_torch.ops.cuda.paged_attention import \
        paged_attention_varlen_plain as latent_plain      # K6's plain version
    from hydrainfer_tpu_torch.ops.cuda import split_kv
    from hydrainfer_tpu_torch.ops.cuda.paged_attention_latent import \
        paged_attention_latent
    cfg, shp = _arch_cfg(path), PATH_SHAPES[path]
    H, D, bs, kv_scale = cfg.n_qo_heads, cfg.head_dim, 16, 0.05
    sm = cfg.mla_softmax_scale or 1.0 / math.sqrt(cfg.mla_nope_dim + cfg.mla_rope_dim)
    forms = {}
    for form in ("decode", "mixed"):
        specs = shp[form]
        T = len(specs) if form == "decode" else shp["T"]
        max_q = max(ql for ql, _ in specs)
        pages, tables, kv_lens, cu, ns = _latent_case(gen, specs, 1024, bs, D, kv_scale,
                                                      dev)
        geo = (pages, kv_lens, tables, cu, ns, sm, kv_scale)
        T_real = int(cu[-1])
        q32 = torch.randn((T, H, D), generator=gen).to(dev)
        q16 = q32.to(torch.bfloat16)
        kernel = lambda: paged_attention_latent(q16, *geo, max_q=max_q)
        got16 = kernel()
        ref16 = latent_plain(q16.float(), *geo)
        err16 = (got16.float() - ref16).abs().max().item()
        tol16 = 2e-2 * max(1.0, ref16.abs().max().item())
        got32 = paged_attention_latent(q32, *geo, max_q=max_q)
        ref32 = latent_plain(q32, *geo)
        err32 = (got32 - ref32).abs().max().item()
        tol32 = 1e-4 * max(1.0, ref32.abs().max().item())
        pad_zero = bool((got16[T_real:] == 0).all() and (got32[T_real:] == 0).all())
        # the library yardsticks: the plane of each sequence gathered dense
        # and dequantized (bf16); decode: sequences batched, padded and
        # masked; mixed: all sequences side by side under one bool mask;
        # aten's memory-efficient varlen forward with a bottom-right causal
        # mask computes only the visible pairs, as K6 does
        dense = [(pages[tables[s].long()].reshape(-1, D)[: int(kv_lens[s])].float()
                  * kv_scale).to(torch.bfloat16) for s in range(len(specs))]
        visible = sum(kvl - ql + i + 1 for ql, kvl in specs for i in range(ql))
        if form == "decode":
            L = max(x.shape[0] for x in dense)
            kv = torch.zeros((len(specs), 1, L, D), dtype=torch.bfloat16, device=dev)
            mask = torch.zeros((len(specs), 1, 1, L), dtype=torch.bool)
            for s, x in enumerate(dense):
                kv[s, 0, :x.shape[0]] = x
                mask[s, ..., :x.shape[0]] = True
            qv, sdpa_flat = q16[:, :, None, :], (lambda o: o[:, :, 0])   # (S, H, 1, D)
        else:
            kv = torch.cat(dense)[None, None]                     # (1, 1, sum kv, D)
            mask = torch.zeros((T_real, kv.shape[2]), dtype=torch.bool)
            t0, c0 = 0, 0
            for ql, kvl in specs:
                for i in range(ql):
                    mask[t0 + i, c0:c0 + kvl - ql + i + 1] = True
                t0, c0 = t0 + ql, c0 + kvl
            qv = q16[:T_real].transpose(0, 1)[None]               # (1, H, T_real, D)
            sdpa_flat = lambda o: o[0].transpose(0, 1)
        calls = {n: (make, sdpa_flat)
                 for n, make in _sdpa_calls(qv, kv, mask.to(dev), sm).items()}
        flat = torch.cat(dense)[None, :, None, :].expand(1, -1, H, D)
        cu_k = torch.tensor([0] + [kvl for _, kvl in specs], device=dev).cumsum(0).int()
        calls["aten._efficient_attention_forward/varlen"] = (
            lambda: lambda: torch.ops.aten._efficient_attention_forward(
                q16[None, :T_real], flat, flat, None, cu[:len(specs) + 1], cu_k, max_q,
                max(kvl for _, kvl in specs), 0.0, 2, False, scale=sm)[0],
            lambda o: o[0])
        lib, lib_name = _fastest(calls, ref16[:T_real], tol16)
        n_kv = int(kv_lens.sum())
        b_ms, b_by = bound_ms(2 * T_real * H * D * 2 + n_kv * D
                              + 4 * (tables.numel() + 2 * len(specs) + 2),
                              4.0 * H * D * visible)
        forms[form] = {
            "ok": bool(err16 <= tol16 and err32 <= tol32 and pad_zero),
            "max_abs_err": err16, "f32_max_abs_err": err32, "tol": tol16,
            "f32_tol": tol32, "padding_rows_zero": pad_zero,
            "shape": f"{T_real} tokens (T={T}) in {len(specs)} seqs, kv "
                     f"{min(kv for _, kv in specs)}..{max(kv for _, kv in specs)}; "
                     f"{H} q heads over one int8 plane x d{D}, BS 16",
            "ms": time_ms(kernel), "graph_ms": graph_ms(kernel),
            "f32_ms": time_ms(lambda: paged_attention_latent(q32, *geo, max_q=max_q)),
            "plain_ms": time_ms(lambda: latent_plain(q16, *geo), iters=5),
            "bound_ms": b_ms, "bound_by": b_by, "visible_pairs": visible,
            "library_ms": lib[lib_name]["ms"] if lib_name else None,
            "library_graph_ms": lib[lib_name].get("graph_ms") if lib_name else None,
            "library": f"{lib_name}, K = V = the gathered dense plane" if lib_name else None,
            "library_backends": lib}
        del pages, q16, q32, kv, mask, calls
    # the mla round's drain steps: 16 live sequences in a batch padded to the
    # S = 32 floor (the split count from S = 32) against the same 16 in an
    # S = 16 batch (their split count without the floor)
    specs = shp["decode"][:16]
    pages, tables, kv_lens, cu, ns = _latent_case(gen, specs, 1024, bs, D, kv_scale, dev)
    q16 = torch.randn((16, H, D), generator=gen).to(dev, torch.bfloat16)
    pad = lambda t, fill: torch.cat([t, torch.full((16,) + tuple(t.shape[1:]), fill,   # noqa: E731
                                                   dtype=t.dtype, device=dev)])
    drain, outs = {}, []
    for S, geo in ((16, (pages, kv_lens, tables, cu, ns, sm, kv_scale)),
                   (32, (pages, pad(kv_lens, 0), pad(tables, 0), pad(cu, int(cu[-1])), ns,
                         sm, kv_scale))):
        fn = lambda geo=geo: paged_attention_latent(q16, *geo, max_q=1)   # noqa: E731
        outs.append(fn())
        drain[f"splits_S{S}"] = split_kv.num_splits(S, tables.shape[1] * bs)
        drain[f"graph_ms_S{S}"] = graph_ms(fn)
    drain["max_abs_diff"] = (outs[0].float() - outs[1].float()).abs().max().item()
    forms["drain_16_of_32"] = drain
    save("paged_attention_latent.json" if path == "mla"
         else f"paged_attention_latent_{path}.json", forms)
    # the decode window carries most of the path's launches: it is the row
    row, mixed = forms["decode"], forms["mixed"]
    return [{"name": "paged_attention_latent", "path": path,
             "ok": (row["ok"] and mixed["ok"]
                    and drain["max_abs_diff"] <= 2e-2 * max(1.0, outs[0].abs().max().item())),
             "drain_16_of_32": drain,
             "max_abs_err": max(row["max_abs_err"], mixed["max_abs_err"]),
             "tolerance": "bf16: 2e-2 x max(1, max|plain|) against the plain version in "
                          "f32 on the same inputs (bf16 P and output rounding); f32: "
                          "1e-4 x the same (sum order)",
             **{k: row[k] for k in ("shape", "ms", "graph_ms", "plain_ms", "bound_ms",
                                    "bound_by", "library_ms", "library_graph_ms",
                                    "library")},
             **{f"mixed_{k}": mixed[k] for k in ("ms", "graph_ms", "bound_ms", "library_ms",
                                                 "library_graph_ms")}}]


KV_SENTINEL = -128      # never written by K3's quantize, which clips at -127


def check_kv_writer(gen, dev, path, form) -> dict:
    """K3 at the path's decode step or prefill budget (`form`), bf16 rows into
    int8 pages holding a sentinel: bit for bit the host's quantize
    clip(rint(x_f32 / f32(scale)), -127, 127) in the real rows' slots and
    the sentinel everywhere else, within one step of the plain version, and
    two replays of a CUDA graph that captured it leave identical pages. A
    path over a bf16 cache (gpt2) writes the rows as they are: bit for bit
    them, and the plain version's pages exactly."""
    import numpy as np
    import torch
    from hydrainfer_tpu_torch.ops.cuda.kv_writer import write_kv_pages, write_kv_pages_plain
    cfg = _arch_cfg(path)
    H, kvh, D, bs, nb, kv_scale = (cfg.n_qo_heads, cfg.n_kv_heads, cfg.head_dim, 16, 512,
                                   _kv_scale(path))
    cache_dtype = torch.bfloat16 if kv_scale is None else torch.int8
    T, T_real = PATH_SHAPES[path][f"kv_{form}"]
    # a prefill's slots: runs of consecutive slots in shuffled blocks, the
    # padded tail dropped; a decode step's: one slot in each sequence's block
    if form == "decode":
        blocks = torch.randperm(nb, generator=gen)[:T]
        slots = blocks * bs + torch.randint(bs, (T,), generator=gen)
    else:
        blocks = torch.randperm(nb, generator=gen)[: -(-T // bs)]
        slots = (blocks[:, None] * bs + torch.arange(bs)[None]).reshape(-1)[:T]
    slots[T_real:] = -1
    slots = slots.to(torch.int32)
    if _is_mla(cfg):
        # single-plane form: the (T, 1, D) [c_kv | k_pe] rows as they are
        k, v = torch.randn((T, 1, D), generator=gen).to(dev, torch.bfloat16), None
        planes, what = 1, "single-plane latent rows"
        both = k
    else:
        # k as rope returns it; v a column range of the fused qkv projection
        qkv = torch.randn((T, (H + 2 * kvh) * D), generator=gen).to(dev, torch.bfloat16)
        k = qkv[:, H * D: (H + kvh) * D].reshape(T, kvh, D).contiguous()
        v = qkv[:, (H + kvh) * D:].reshape(T, kvh, D)   # strided rows, as in the model
        planes, what = 2 * kvh, f"{kvh} kv heads"
        both = torch.stack([k, v], 2).reshape(T, 2 * kvh, D)
    keep = slots >= 0
    host = (both.cpu() if kv_scale is None else torch.from_numpy(np.clip(
        np.rint(both.float().cpu().numpy() / np.float32(kv_scale)), -127, 127)
        .astype(np.int8)))
    expect = torch.full((nb * bs, planes, D), KV_SENTINEL, dtype=cache_dtype)
    expect[slots[keep].long()] = host[keep]
    slots = slots.to(dev)
    got = torch.full((nb, bs, planes, D), KV_SENTINEL, dtype=cache_dtype, device=dev)
    ref = torch.full_like(got, KV_SENTINEL)
    write_kv_pages(got, k, v, slots, kv_scale)
    write_kv_pages_plain(ref, k, v, slots, kv_scale)
    exact = torch.equal(got.cpu().view(expect.shape), expect)
    err = (got.float() - ref.float()).abs().max().item()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        write_kv_pages(got, k, v, slots, kv_scale)
    replays = []
    for _ in range(2):
        got.fill_(KV_SENTINEL)
        graph.replay()
        torch.cuda.synchronize()
        replays.append(got.cpu())
    replays_equal = bool(torch.equal(*replays))
    rows = host[keep].to(dev)
    flat, idx = ref.view(-1, planes, D), slots[slots >= 0].long()
    b_ms, b_by = bound_ms(T_real * planes * D * (2 + got.element_size()) + T * 4, 0.0)
    return {"name": "kv_writer", "path": path, "form": form,
            "ok": exact and err <= (1.0 if kv_scale else 0.0) and replays_equal,
            "max_abs_err": err,
            "bit_exact_vs_host": exact, "graph_replays_equal": replays_equal,
            "tolerance": ("bit for bit the host's quantize; 1 int8 step from the plain "
                          "version (its division may round through a reciprocal)"
                          if kv_scale else "bit for bit the rows and the plain version"),
            "shape": f"{form}: {T_real} of {T} rows -> "
                     f"{'bf16' if kv_scale is None else 'int8'} pages, {what} x d{D}, BS 16",
            "ms": time_ms(lambda: write_kv_pages(got, k, v, slots, kv_scale)),
            "graph_ms": graph_ms(lambda: write_kv_pages(got, k, v, slots, kv_scale)),
            "plain_ms": time_ms(lambda: write_kv_pages_plain(ref, k, v, slots,
                                                             kv_scale), iters=5),
            "library_ms": time_ms(lambda: flat.index_copy_(0, idx, rows)),
            "library_graph_ms": graph_ms(lambda: flat.index_copy_(0, idx, rows)),
            "bound_ms": b_ms, "bound_by": b_by}


def _k5_vit(gen, dev, sizes, H, D, plain_group: int = 0, d_real: int = 0) -> dict:
    """K5 in the ViT form, one segment of `sizes[i]` rows per image (or
    tile), H heads x dD, bf16, v a strided view of the fused qkv as the
    towers pass it: held against the plain version, timed eager and from a
    CUDA graph beside its bound, the plain version and the fastest library
    form. plain_group > 0: the plain version, which forms (H, T, T), runs
    over groups of that many segments (its outputs concatenated: the same
    function), and the dense-mask SDPA form (a T x T mask) is left out.
    d_real < D: heads of d_real padded with zero columns to D, as SigLIP's
    load-time padding writes them (scale, bound and the library forms at
    d_real; the output's padding columns must be 0)."""
    import torch
    import torch.nn.functional as F
    from hydrainfer_tpu_torch.ops.cuda.mha_varlen import mha_varlen_flash, mha_varlen_plain
    dr = d_real or D
    sm = dr ** -0.5
    ids = torch.cat([torch.full((n,), i, dtype=torch.int32)
                     for i, n in enumerate(sizes)]).to(dev)
    T = ids.shape[0]
    qkv = torch.randn((T, 3, H, D), generator=gen)
    qkv[..., dr:] = 0
    qkv = qkv.to(dev, torch.bfloat16)
    q, k, v = qkv[:, 0].contiguous(), qkv[:, 1].contiguous(), qkv[:, 2]
    starts = [0]
    for n in sizes:
        starts.append(starts[-1] + n)
    g = plain_group or len(sizes)
    groups = [(starts[i], starts[min(i + g, len(sizes))]) for i in range(0, len(sizes), g)]

    def plain():
        return torch.cat([mha_varlen_plain(q[a:b], k[a:b], v[a:b], ids[a:b], sm)[0]
                          for a, b in groups])

    got = mha_varlen_flash(q, k, v, ids, sm)
    ref = plain()
    err = (got.float() - ref.float()).abs().max().item()
    tol = 3e-2 * max(1e-3, ref.float().abs().max().item())
    pad_zero = bool((got[..., dr:] == 0).all())
    pairs = sum(n * n for n in sizes)
    b_ms, b_by = bound_ms(4 * T * H * dr * 2 + 4 * T, 4.0 * H * dr * pairs)
    ms = time_ms(lambda: mha_varlen_flash(q, k, v, ids, sm))
    ms_graph = graph_ms(lambda: mha_varlen_flash(q, k, v, ids, sm))
    plain_ms = time_ms(plain, iters=3)
    if dr < D:          # the library forms compute the unpadded function
        q, k, v = (t[..., :dr].contiguous() for t in (q, k, v))
        ref = ref[..., :dr]
    qs, ks, vs = (t.transpose(0, 1)[None] for t in (q, k, v))
    mask = None if plain_group else ids[:, None] == ids[None, :]
    # library yardsticks, each held to the plain version first; library_ms is
    # the fastest that ran. SDPA with the block-diagonal mask computes all
    # T^2 scores; SDPA over jagged nested q/k/v and aten's varlen flash
    # forward (one segment per image) compute sum n_i^2, as K5 does.
    offsets = torch.tensor([0] + sizes, device=dev).cumsum(0)
    vc, cu = v.contiguous(), offsets.int()

    def jagged():
        qn, kn, vn = (torch.nested.nested_tensor_from_jagged(t, offsets).transpose(1, 2)
                      for t in (q, k, vc))
        return lambda: F.scaled_dot_product_attention(qn, kn, vn)

    forms = {
        "SDPA, block-diagonal bool mask": (
            lambda: lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask),
            lambda o: o[0].transpose(0, 1)),
        "SDPA on jagged nested q/k/v": (jagged, lambda o: o.transpose(1, 2).values()),
        "aten._flash_attention_forward, varlen": (
            lambda: lambda: torch.ops.aten._flash_attention_forward(
                q, k, vc, cu, cu, max(sizes), max(sizes), 0.0, False, False, scale=sm)[0],
            lambda o: o),
    }
    if plain_group:
        del forms["SDPA, block-diagonal bool mask"]
    library, lib = _fastest(forms, ref, tol)
    return {"T": T, "images": sizes, "err": err, "tol": tol, "ms": ms, "graph_ms": ms_graph,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library": library,
            "lib": lib, "plain_groups": len(groups), "padding_columns_zero": pad_zero}


def _k5_row(vit: dict, path: str, ok: bool, err: float, shape: str) -> dict:
    lib = vit["lib"]
    return {"name": "mha_varlen", "path": path, "ok": bool(ok), "max_abs_err": err,
            "tolerance": "3e-2 x max|plain| (bf16 P and output rounding)", "shape": shape,
            "ms": vit["ms"], "graph_ms": vit["graph_ms"], "plain_ms": vit["plain_ms"],
            "bound_ms": vit["bound_ms"], "bound_by": vit["bound_by"],
            "library_ms": vit["library"][lib]["ms"] if lib else None, "library": lib,
            "library_graph_ms": vit["library"][lib].get("graph_ms") if lib else None,
            "library_forms_ms": {n: r.get("ms") for n, r in vit["library"].items()}}


def check_mha_varlen_llava(gen, dev) -> dict:
    """K5 at the llava phase's encode shape: LLaVA_IMAGES images of CLIP-L's
    577 rows (the class token and 24 x 24 patches), 16 heads x d64."""
    from hydrainfer_tpu_torch.models.random_init import CLIP_L_336 as c
    L, H = c.n_patches + 1, c.n_heads
    vit = _k5_vit(gen, dev, [L] * LLAVA_REQUESTS, H, c.hidden_size // H)
    save("mha_varlen_llava.json", {k: vit[k] for k in ("T", "images", "err", "tol",
                                                       "library")})
    return _k5_row(vit, "llava", vit["err"] <= vit["tol"], vit["err"],
                   f"ViT form: {LLAVA_REQUESTS} images x {L} rows (CLIP-L/14-336), "
                   f"{H} heads x d{c.hidden_size // H}, bf16, v strided")


def check_mha_varlen_tiles(gen, dev, path) -> dict:
    """K5 at a tiling tower's encode shape: the tiles of the phase's eight
    images, one segment a tile; the plain version over groups of 4 tiles
    (next13b: 34 tiles of CLIP-L's 577 rows, 16 heads x d64; internvl: 48 of
    InternViT-300M's 1025, 16 x d64; vl2: 28 of SigLIP's 784, 16 heads of
    72 padded to 80)."""
    from hydrainfer_tpu_torch.models import deepseek_vl2, internvl, llavanext
    from hydrainfer_tpu_torch.models.random_init import CLIP_L_336
    d_real = 0
    if path == "next13b":
        calc = llavanext.LlavaNextImageTokenCalculator(llavanext.DEFAULT_PINPOINTS, 336,
                                                       24)
        images, rows, H, D = NEXT_IMAGES, CLIP_L_336.n_patches + 1, 16, 64
        what = "CLIP-L/14-336"
    elif path == "vl2":
        vcfg = deepseek_vl2.SigLIPConfig(**VL2_VISION)
        calc = deepseek_vl2.DeepSeekVL2ImageTokenCalculator(deepseek_vl2.DEFAULT_CANDIDATES)
        images, rows, H = VL2_IMAGES, vcfg.n_patches_side ** 2, vcfg.n_heads
        D, d_real = deepseek_vl2.padded_head_dim(vcfg), vcfg.hidden_size // vcfg.n_heads
        what = "SigLIP-so400m-384"
    else:
        calc = internvl.InternVLImageTokenCalculator(256, 448, 12, True)
        images, rows, H = INTERNVL_IMAGES, 1 + (448 // 14) ** 2, INTERNVL_VIT["n_heads"]
        D, what = INTERNVL_VIT["hidden_size"] // H, "InternViT-300M-448px"
    n_tiles = sum(calc.n_tiles(hw) for hw in images)
    vit = _k5_vit(gen, dev, [rows] * n_tiles, H, D, plain_group=4, d_real=d_real)
    save(f"mha_varlen_{path}.json", {k: vit[k] for k in ("T", "err", "tol", "library",
                                                        "padding_columns_zero")})
    heads = f"{H} heads x d{d_real} padded to {D}" if d_real else f"{H} heads x d{D}"
    return _k5_row(vit, path, vit["err"] <= vit["tol"] and vit["padding_columns_zero"],
                   vit["err"], f"ViT form: {n_tiles} tiles x {rows} rows ({what}), {heads}, "
                   "bf16, v strided; plain version over groups of 4 tiles")


def check_grouped_mm(gen, dev, model="deepseek") -> dict:
    """The MoE grouped product (torch._grouped_mm: a library call, as JAX's
    ragged_dot; no TPU kernel) at a model's experts: DeepSeek-V2-Lite's, 64 x
    (2048 -> 2 x 1408) and (1408 -> 2048), top-6 softmax routing; or
    Mixtral-8x7B's, 8 x (4096 -> 2 x 14336) and (14336 -> 4096), top-2
    renormalised (its weights drawn on the card: 2.8 GB); or ("deepseek_tp2")
    rank 0's of V2-Lite's at tp 2: its 32 experts, the routing over all 64
    masked to them as the rank masks it (another rank's pair to local
    expert 0 at weight 0: the dispatch keeps its T * 6 rows); bf16, at a
    decode step (T = 32) and a prefill budget (T = 2048), rows routed by random
    logits: each product held to the per-group f32 matmul, timed eager and
    from a CUDA graph beside its bound (the experts the routing touched read
    once, the rows read and written once; 2 n K N operations); and the whole
    moe_ffn (sort, both products, the weighted combine) at T = 32 from a CUDA
    graph, held to moe_ffn_dense."""
    import torch
    from hydrainfer_tpu_torch.ops import moe
    if model == "mixtral":
        text = MIXTRAL_8X7B
        d, I, E = text["hidden_size"], text["intermediate_size"], text["num_local_experts"]
        wgen = torch.Generator(device=dev).manual_seed(SEED + 21)
        draw = lambda *shape: (torch.randn(shape, generator=wgen, device=dev)  # noqa: E731
                               * 0.02).to(torch.bfloat16)
        norm_topk = True
    else:
        text = DEEPSEEK_V2_LITE
        d, I, E = text["hidden_size"], text["moe_intermediate_size"], text["n_routed_experts"]
        draw = lambda *shape: (torch.randn(shape, generator=gen)  # noqa: E731
                               * 0.02).to(dev, torch.bfloat16)
        norm_topk = False
    k, n_route = text["num_experts_per_tok"], E
    if model == "deepseek_tp2":
        E //= TP_SIZE
    w_gu, w_dn = draw(E, d, 2 * I), draw(E, I, d)
    out, ok = {}, True
    for T in (32, 2048):
        logits = torch.randn((T, n_route), generator=gen).to(dev)
        weights, ids = moe.route(logits, k, norm_topk=norm_topk)
        local = ids < E
        weights, ids = torch.where(local, weights, 0.0), torch.where(local, ids, 0)
        _, offs = moe.dispatch_offsets(ids, E)
        ends = offs.tolist()
        n = ids.numel()
        touched = sum(b > a for a, b in zip([0] + ends[:-1], ends))
        row = {"rows": n, "experts_touched": touched}
        for name, w in (("gate_up", w_gu), ("down", w_dn)):
            K, N = w.shape[1], w.shape[2]
            x = torch.randn((n, K), generator=gen).to(dev, torch.bfloat16)
            got = moe.grouped_mm(x, w, offs)
            ref = torch.cat([x[a:b].float() @ w[e].float()
                             for e, (a, b) in enumerate(zip([0] + ends[:-1], ends))])
            err = (got.float() - ref).abs().max().item()
            tol = 1e-2 * max(1.0, ref.abs().max().item())
            ok &= err <= tol
            fn = lambda x=x, w=w: moe.grouped_mm(x, w, offs)   # noqa: E731
            b_ms, b_by = bound_ms(touched * K * N * 2 + n * (K + N) * 2 + 4 * E,
                                  2.0 * n * K * N)
            row[name] = {"K": K, "N": N, "max_abs_err": err, "tol": tol, "ms": time_ms(fn),
                         "graph_ms": graph_ms(fn), "bound_ms": b_ms, "bound_by": b_by}
        row["both_graph_ms"] = row["gate_up"]["graph_ms"] + row["down"]["graph_ms"]
        row["both_bound_ms"] = row["gate_up"]["bound_ms"] + row["down"]["bound_ms"]
        if T == 32:
            x = torch.randn((T, d), generator=gen).to(dev, torch.bfloat16)
            fn = lambda: moe.moe_ffn(x, w_gu, w_dn, weights, ids)   # noqa: E731
            ref = moe.moe_ffn_dense(x, w_gu, w_dn, weights, ids).float()
            err = (fn().float() - ref).abs().max().item()
            tol = 2e-2 * max(1e-3, ref.abs().max().item())
            ok &= err <= tol
            row["moe_ffn"] = {"max_abs_err": err, "tol": tol, "ms": time_ms(fn),
                              "graph_ms": graph_ms(fn)}
        out[f"T={T}"] = row
    save("grouped_mm.json" if model == "deepseek" else f"grouped_mm_{model}.json", out)
    name = {"deepseek": "DeepSeek-V2-Lite", "mixtral": "Mixtral-8x7B",
            "deepseek_tp2": f"DeepSeek-V2-Lite rank 0 of {TP_SIZE}"}[model]
    return {"ok": bool(ok), "what": f"torch._grouped_mm at {name}'s experts, bf16 "
                                    "(library; the port's MoE dispatch)",
            "tolerance": "1e-2 x max(1, max|f32 per-group matmul|); moe_ffn 2e-2 x "
                         "max|moe_ffn_dense| (bf16 rounding of h and of the down product)",
            **out}


def check_mha_varlen(gen, dev) -> dict:
    """K5 (a) in the ViT form at the vlm encode shape (T = 6784, 16 heads,
    d80, bf16, v a strided view of the fused qkv as the tower passes it) and
    (b) in the causal form over gathered pages, as
    hydrainfer_tpu/ops/attention.py:paged_attention_varlen_prefill builds
    it (Qwen2-VL-2B LM heads, d128)."""
    import torch
    from hydrainfer_tpu_torch.ops.cuda.mha_varlen import mha_varlen_flash, mha_varlen_plain
    H = VLM_VISION["num_heads"]
    # one segment per image of the vlm encode (14 x 14 patches)
    vit = _k5_vit(gen, dev, [(h // 14) * (w // 14) for h, w in VLM_IMAGES], H,
                  VLM_VISION["embed_dim"] // H)
    err, tol, T = vit["err"], vit["tol"], vit["T"]

    # (b) the causal form: gathered pages with segment ids (-1 past each
    # kv_len) and cache positions; q rows carry their cache position
    specs = [(128, 128), (64, 192), (1, 150), (100, 100), (1, 77)]
    Hq, Dq = 12, 128
    max_kv = max(kv for _, kv in specs)
    S = len(specs)
    kv_pos = torch.arange(max_kv, dtype=torch.int32).repeat(S)
    kv_len = torch.tensor([kv for _, kv in specs], dtype=torch.int32).repeat_interleave(max_kv)
    kv_seg = torch.where(kv_pos < kv_len,
                         torch.arange(S, dtype=torch.int32).repeat_interleave(max_kv), -1)
    q_ids = torch.cat([torch.full((ql,), s, dtype=torch.int32)
                       for s, (ql, _) in enumerate(specs)] + [torch.full((7,), -1)])
    q_pos = torch.cat([torch.arange(kv - ql, kv, dtype=torch.int32) for ql, kv in specs]
                      + [torch.zeros(7, dtype=torch.int32)])
    on = lambda t: t.to(torch.int32).to(dev)
    cq = torch.randn((q_ids.shape[0], Hq, Dq), generator=gen).to(dev, torch.bfloat16)
    ck, cv = (torch.randn((S * max_kv, Hq, Dq), generator=gen).to(dev, torch.bfloat16)
              for _ in range(2))
    cargs = dict(kv_seq_ids=on(kv_seg), q_pos=on(q_pos), kv_pos=on(kv_pos))
    cgot = mha_varlen_flash(cq, ck, cv, on(q_ids), Dq ** -0.5, **cargs)
    cref = mha_varlen_plain(cq, ck, cv, on(q_ids), Dq ** -0.5, **cargs)[0]
    cerr = (cgot.float() - cref.float()).abs().max().item()
    ctol = 3e-2 * max(1e-3, cref.float().abs().max().item())
    pad_zero = bool((cgot[on(q_ids) < 0] == 0).all())
    save("mha_varlen.json", {"vit": {k: vit[k] for k in ("T", "images", "err", "tol",
                                                        "library")},
                             "causal": {"specs": specs, "err": cerr, "tol": ctol,
                                        "padding_rows_zero": pad_zero}})
    return {**_k5_row(vit, "vlm", err <= tol and cerr <= ctol and pad_zero, max(err, cerr),
                      f"ViT form: {T} patches of 8 images, {H} heads x "
                      f"d{VLM_VISION['embed_dim'] // H}, bf16; "
                      "causal form: 5 seqs over gathered pages, 12 heads x d128"),
            "causal_max_abs_err": cerr}


def check_verify(gen, dev) -> list:
    """K2 and K4 at the speculative verify step's shape (VERIFY_SHAPES)."""
    v = VERIFY_SHAPES
    k2 = check_paged_mixed(gen, dev, "spec", v["mixed"], v["T"],
                           f"verify segments of {v['K1']} rows (max_q 16)")
    return [k2, check_quant_matmul(gen, dev, "spec", m_values=(v["T"],))]


def _launch_key(r: dict) -> str:
    """The kernel's name in a path's launch counts; K3's rows add their form
    (the split that KvWriteSplit counts)."""
    return r["name"] + (f":{r['form']}" if "form" in r else "")


def phase_kernels() -> tuple:
    import torch
    gen = torch.Generator().manual_seed(SEED)
    dev = torch.device("cuda")
    results, seconds = [], {}

    def run(name, fn, *args):
        """A check's rows, and its seconds (host clock, data made included)."""
        t0 = time.perf_counter()
        rows = fn(gen, dev, *args)
        seconds[name] = time.perf_counter() - t0
        results.extend(rows if isinstance(rows, list) else [rows])

    for path in PATH_SHAPES:
        if _is_mla(_arch_cfg(path)):
            run(f"latent@{path}", check_latent, path)
        else:
            run(f"attention@{path}", check_attention, path)
        run(f"kv_writer@{path}", lambda g, d: [check_kv_writer(g, d, path, "decode"),
                                               check_kv_writer(g, d, path, "prefill")])
        if _runs_k4(path):
            run(f"quant_matmul@{path}", check_quant_matmul, path)
    run("verify", check_verify)
    for mode in QUANT_MODES:
        run(f"quant_matmul_{mode}", check_quant_forms, mode)
    run("mha_varlen@vlm", check_mha_varlen)
    run("mha_varlen@llava", check_mha_varlen_llava)
    for path in ("next13b", "internvl", "vl2"):
        run(f"mha_varlen@{path}", check_mha_varlen_tiles, path)
    grouped = {}
    for model in ("deepseek", "mixtral", "deepseek_tp2"):
        t0 = time.perf_counter()
        grouped[model] = check_grouped_mm(gen, dev, model)
        seconds[f"grouped_mm@{model}"] = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    save("kernels.json", results)
    ok = all(r["ok"] for r in results) and all(g["ok"] for g in grouped.values())
    return {"phase": "kernels", "ok": ok, "check_s": seconds,
            "grouped_mm": grouped["deepseek"], "grouped_mm_mixtral": grouped["mixtral"],
            "grouped_mm_tp": grouped["deepseek_tp2"],
            "checks": {f"{_launch_key(r)}@{r['path']}": {
                "ok": r["ok"], "max_abs_err": r["max_abs_err"], "ms": r["ms"]}
                for r in results}}, results


# ------------------------------------------------------------------ serving

def _engine(factory, device, n_requests, block_size, n_blocks, token_budget,
            node_type="PD", n_image_blocks=-1, cuda_graphs=True, spec_ngram_k=12,
            encode_chunk_layers=0, multi_step_decode=16, parallel="tp"):
    """An OfflineEngine with the boot warm-up on (the key floors raised to
    the serving envelope, the decode keys met and, with cuda_graphs on the
    card, captured; a model without fused windows skips it), a fixed token
    budget (the budget search off), K = multi_step_decode windows,
    speculation at the JAX default (spec_ngram_k = 12) unless asked, and the
    whole-tower encode unless encode_chunk_layers asks for segments. A list
    of devices makes its node tensor-parallel, or with parallel "pp"
    pipeline-parallel."""
    from hydrainfer_tpu_torch.entrypoint.offline import OfflineEngine
    cfg = _node_config(n_requests, block_size, n_blocks, token_budget, n_image_blocks,
                       cuda_graphs, spec_ngram_k, encode_chunk_layers, multi_step_decode)
    return OfflineEngine(cfg, model_factory=factory, node_type=node_type, device=device,
                         parallel=parallel)


def _node_config(n_requests, block_size, n_blocks, token_budget, n_image_blocks=-1,
                 cuda_graphs=True, spec_ngram_k=12, encode_chunk_layers=0,
                 multi_step_decode=16):
    """_engine's NodeConfig."""
    from hydrainfer_tpu_torch.cluster.node import NodeConfig
    from hydrainfer_tpu_torch.engine.profiler import BatchSchedulerProfilerConfig
    from hydrainfer_tpu_torch.engine.request_processor import RequestProcessorConfig
    from hydrainfer_tpu_torch.engine.scheduler import BatchSchedulerConfig
    return NodeConfig(
        batch_scheduler=BatchSchedulerConfig(max_running_requests=n_requests),
        request_processor=RequestProcessorConfig(num_request_process_workers=1),
        profiler=BatchSchedulerProfilerConfig(enabled=False,
                                              default_token_budget=token_budget),
        kv_block_size=block_size, n_kv_blocks=n_blocks, n_image_blocks=n_image_blocks,
        multi_step_decode=multi_step_decode, cuda_graphs=cuda_graphs, boot_warmup=True,
        spec_ngram_k=spec_ngram_k, encode_chunk_layers=encode_chunk_layers)


def _requests(rng, n, prompt_len, max_tokens, tag):
    from hydrainfer_tpu_torch.request import Request, SamplingParameters
    letters = "abcdefghijklmnopqrstuvwxyz "
    return [Request(request_id=f"{tag}{i}",
                    prompt="".join(rng.choice(list(letters), size=prompt_len)),
                    sampling_params=SamplingParameters(max_tokens=max_tokens,
                                                       ignore_eos=True))
            for i in range(n)]


# the tiny phase's speculating requests (tests/engine/test_spec_decode.py's
# lookup-friendly prompts), two on a node of four: single steps, each a chance
# to speculate at spec_ngram_k = 3
TINY_SPEC_PROMPTS = ("abc abc abc abc abc abc", "ab ab ab ab ab")


def phase_tiny(devices=("cuda", "cpu"), archs=("tiny-lm", "mla-tiny-lm")) -> dict:
    """Each arch in f32 on the card and on the CPU with the same weights
    (mla-tiny-lm: K6's f32 path at D 24, K3's single-plane write): six
    random requests, then TINY_SPEC_PROMPTS with speculation at k = 3. The
    tokens must be identical, and so must the verify steps run and the
    tokens they emitted (at least one); on the card the verify key runs
    from its CUDA graph."""
    import numpy as np
    import torch
    from hydrainfer_tpu_torch.models.random_init import (ARCH_CONFIGS,
                                                         RandomWeightFactory,
                                                         init_decoder_weights)
    from hydrainfer_tpu_torch.request import Request, SamplingParameters

    def on(arch, weights, device):
        w = {k: (v.to(device) if k != "layers" else
                 [{n: t.to(device) for n, t in lw.items()} for lw in v])
             for k, v in weights.items()}
        factory = RandomWeightFactory(arch, dtype=torch.float32, device=device,
                                      weights=w)
        engine = _engine(factory, device, 6, 4, 512, 24)
        reqs = _requests(np.random.default_rng(SEED), 6, 40, 24, "tiny")
        plain = [o.output_token_ids for o in engine.generate(reqs, timeout_s=300)]
        engine = _engine(factory, device, 4, 4, 512, 24, spec_ngram_k=3)
        reqs = [Request(request_id=f"spec{i}", prompt=p,
                        sampling_params=SamplingParameters(max_tokens=24, ignore_eos=True))
                for i, p in enumerate(TINY_SPEC_PROMPTS)]
        spec = [o.output_token_ids for o in engine.generate(reqs, timeout_s=300)]
        fx = engine.node.fill_executor
        verify_replays = (sum(g.replays for (d, _), g in fx.graphs.graphs.items()
                              if d.spec > 0) if fx.graphs is not None else None)
        return plain, spec, (fx.spec_steps, fx.spec_tokens), verify_replays

    res, ok, tokens = {"phase": "tiny"}, True, {}
    for arch in archs:
        weights = init_decoder_weights(ARCH_CONFIGS[arch], SEED, torch.float32,
                                       device="cpu")
        (gpu, gpu_spec, gpu_counts, replays), (cpu, cpu_spec, cpu_counts, _) = (
            on(arch, weights, d) for d in devices)
        tokens[arch] = {"gpu": gpu, "cpu": cpu, "gpu_spec": gpu_spec, "cpu_spec": cpu_spec}
        ok &= (gpu == cpu and all(len(t) == 24 for t in gpu) and gpu_spec == cpu_spec
               and all(len(t) == 24 for t in gpu_spec) and gpu_counts == cpu_counts
               and gpu_counts[0] > 0 and bool(replays))
        res[arch] = {"requests": len(gpu), "tokens_per_request": 24,
                     "requests_differing": sum(a != b for a, b in zip(gpu, cpu)),
                     "spec_requests_differing": sum(a != b for a, b in zip(gpu_spec,
                                                                           cpu_spec)),
                     "spec_steps_and_tokens": {"gpu": gpu_counts, "cpu": cpu_counts},
                     "verify_graph_replays": replays}
    save("tiny_tokens.json", tokens)
    return {**res, "ok": bool(ok)}


def _prefill_batches(cfg, tokens, device, positions=None, positions_hw=None,
                     image_features=None, image_dst_idx=None, chunk=0, every=0):
    """The batches of one prefill on a scratch cache (block 0 left out):
    [(batch, rows)], and the cache's shape. Rope positions default to
    0..T-1; an image-bearing prefill passes its M-RoPE streams and the
    features spliced at image_dst_idx. chunk > 0: the prompt goes in chunks
    of that many tokens, each after the cache the earlier ones wrote, with
    the image features of its own positions (as a budget cuts a long
    prompt). Each chunk samples its last token, and with every > 0 also
    every every-th token."""
    import torch
    from hydrainfer_tpu_torch.models.factory import LanguageModelBatch
    from hydrainfer_tpu_torch.ops.attention import PagedAttentionParams
    T, bs = len(tokens), 16
    nb = -(-T // bs) + 1
    planes = 1 if _is_mla(cfg) else 2 * cfg.n_kv_heads
    i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=device)  # noqa: E731
    pos = list(range(T)) if positions is None else list(positions)
    dst = [] if image_dst_idx is None else list(image_dst_idx)
    out = []
    for a in range(0, T, chunk or T):
        b = min(T, a + (chunk or T))
        n = b - a
        attn = PagedAttentionParams(
            q_seq_ids=i32([0] * n), q_local_ids=i32(list(range(n))), positions=i32(pos[a:b]),
            kv_lens=i32([b]), block_tables=i32([list(range(1, nb))]),
            new_kv_slot_ids=i32([bs + t for t in range(a, b)]), cu_q_lens=i32([0, n]),
            num_seqs=i32([1]))
        # the features of this chunk's image positions (dst is ascending)
        rows = [i for i, d in enumerate(dst) if a <= d < b]
        sampled = sorted(set(range(every - 1, n, every)) | {n - 1}) if every else [n - 1]
        out.append((LanguageModelBatch(
            token_ids=i32(tokens[a:b]), positions=attn.positions, attention=attn,
            sample_token_idx=i32(sampled), token_src_slots=i32([-1] * n),
            sample_dst_slots=i32([-1] * len(sampled)),
            image_features=image_features[rows[0]:rows[-1] + 1] if rows else None,
            image_dst_idx=i32([dst[i] - a for i in rows]) if rows else None,
            positions_hw=(None if positions_hw is None
                          else i32([list(h[a:b]) for h in positions_hw]))), n))
    return out, (cfg.n_layers, 1, nb, bs, planes, cfg.head_dim)


def _prefill_logits(lm, tokens, device, **batch_kw):
    """One prefill of `lm` (_prefill_batches) on a scratch cache (a
    tensor-parallel model's: one shard a rank); returns the sampled rows'
    f32 logits, (rows, vocab)."""
    import torch
    batches, shape = _prefill_batches(lm.cfg, tokens, device, **batch_kw)
    int8_kv = getattr(lm.cfg, "kv_scale", None) is not None      # GPT-2: none
    dtype = torch.int8 if int8_kv else lm.dtype
    if getattr(lm, "tp_size", 1) > 1:
        cache = [torch.zeros(shape[:-2] + (s.count, shape[-1]), dtype=dtype, device=s.device)
                 for s in lm.weights.cache_shards()]
    else:
        cache = torch.zeros(shape, dtype=dtype, device=device)
    out = []
    for batch, n in batches:
        _, _, logits = lm.forward_with_logits(cache, batch, n)
        out.append(logits.float())
    return torch.cat(out)


def _f32_tree(x):
    """A weight tree with f32 activations: float tensors to f32, int8
    matrices shared as they are, dicts, lists and pairs walked."""
    import torch
    if isinstance(x, dict):
        return {k: _f32_tree(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_f32_tree(v) for v in x)
    return x.float() if isinstance(x, torch.Tensor) else x


def _f32_lm(lm):
    """The same model with f32 activations and an f32 KV cache."""
    from dataclasses import replace
    from hydrainfer_tpu_torch.models.gpt2 import GPT2ForCausalLM
    from hydrainfer_tpu_torch.models.llama import LlamaForCausalLM
    if isinstance(lm, GPT2ForCausalLM):
        return GPT2ForCausalLM(_f32_tree(lm.weights), lm.cfg)
    return LlamaForCausalLM(_f32_tree(lm.weights), replace(lm.cfg, kv_scale=None))


def _plain_swaps() -> list:
    """(module, name, plain version) of every kernel wrapper the model code
    looks up by name at call time."""
    from hydrainfer_tpu_torch.ops import attention, cache_ops, quant
    from hydrainfer_tpu_torch.ops.cuda import (kv_writer, mha_decode, paged_attention,
                                               quant_matmul)
    return [(quant, "quant_matmul_int8", quant_matmul.quant_matmul_int8_plain),
            (quant, "quant_matmul_int4", quant_matmul.quant_matmul_int4_plain),
            (quant, "quant_matmul_fp8", quant_matmul.quant_matmul_fp8_plain),
            (cache_ops, "write_kv_pages", kv_writer.write_kv_pages_plain),
            (attention, "mha_decode_attention", mha_decode.mha_decode_attention_plain),
            (attention, "paged_attention_varlen",
             paged_attention.paged_attention_varlen_plain),
            (attention, "paged_attention_latent",
             paged_attention.paged_attention_varlen_plain)]


class _Plain:
    """Within it, every kernel wrapper is swapped for its plain PyTorch
    version."""

    def __enter__(self):
        swaps = _plain_swaps()
        self.saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
        for mod, name, fn in swaps:
            setattr(mod, name, fn)

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


def _plain_logits(lm, tokens, device, **batch_kw):
    """The same prefill with every kernel wrapper swapped for its plain
    PyTorch version."""
    with _Plain():
        return _prefill_logits(lm, tokens, device, **batch_kw)


def _layered_f32_logits(lm, tokens, device, **batch_kw):
    """The f32 prefill through the kernels and through the plain versions,
    built one layer at a time: each layer is cast to f32 (int8 matrices
    shared), run over every chunk on both paths (each with its own f32
    cache) and freed, so the f32 copy held at once is one layer's, not the
    model's. The same arithmetic as _prefill_logits on _f32_lm(lm):
    decoder_forward's embedding, layers and head. In a MoE layer the plain
    path takes the kernel path's routing (expert ids and weights): the two
    differ by summation order only, and where that moves a choice at a near
    tie the expert's output, not the arithmetic, would set the difference.
    Such choices are counted, each with the plain path's gap between its
    top-k-th and (k+1)-th score. Returns (kernels, plain) f32 logits and
    {"routing_flips", "routing_flip_max_gap"}."""
    from dataclasses import replace
    import torch
    from hydrainfer_tpu_torch.models import decoder
    from hydrainfer_tpu_torch.ops import moe
    from hydrainfer_tpu_torch.ops.rope import mrope_gather
    cfg = replace(lm.cfg, kv_scale=None)
    batches, shape = _prefill_batches(cfg, tokens, device, **batch_kw)
    table = torch.zeros(2, dtype=torch.int32, device=device)
    embed = lm.weights["embed"].float()
    xs, ropes = [], []
    for batch, _ in batches:
        xs.append(decoder._splice_images(embed[batch.token_ids.long()], batch))
        if cfg.mrope_section and batch.positions_hw is not None:
            ropes.append(mrope_gather(lm.cos_tab, lm.sin_tab, batch.positions,
                                      batch.positions_hw[0], batch.positions_hw[1],
                                      cfg.mrope_section))
        else:
            ropes.append((lm.cos_tab[batch.positions.long()],
                          lm.sin_tab[batch.positions.long()]))
    del embed
    paths = {"kernels": ([x for x in xs], torch.zeros(shape, device=device), []),
             "plain": ([x for x in xs], torch.zeros(shape, device=device), [])}
    head = {"norm": lm.weights["norm"].float(), "lm_head": _f32_tree(lm.weights["lm_head"])}
    last = cfg.n_layers - 1
    route, taken, flips = decoder._route, [], []

    def record(h, lw, cfg):
        taken.append(route(h, lw, cfg))
        return taken[-1]

    def replay(h, lw, cfg):
        _, idx = route(h, lw, cfg)
        kw, kidx = taken.pop(0)
        differ = (idx.sort(dim=-1).values != kidx.sort(dim=-1).values).any(dim=-1)
        if bool(differ.any()):
            scores = moe.route_scores(decoder.router_logits(h, lw), cfg.moe_scoring)
            top = torch.topk(scores, cfg.moe_top_k + 1, dim=-1).values
            flips.extend((top[:, -2] - top[:, -1])[differ].tolist())
        return kw, kidx

    try:
        for layer_id, lw in enumerate(lm.weights["layers"]):
            lw32 = _f32_tree(lw)
            for name, (x, cache, logits) in paths.items():
                decoder._route = replay if name == "plain" else record
                with _Plain() if name == "plain" else contextlib.nullcontext():
                    for i, (batch, n) in enumerate(batches):
                        cos, sin = ropes[i]
                        if layer_id < last:
                            x[i] = decoder._layer_body(x[i], cache, layer_id, lw32, batch,
                                                       cos, sin, cfg, n)
                        else:
                            rank = decoder.Rank(x[i].device, cache, batch, cos, sin)
                            _, lg = decoder._head(head, decoder._last_layer(
                                x[i], [rank], [lw32], layer_id, cfg, n), batch, cfg, table,
                                True)
                            logits.append(lg.float())
            del lw32
    finally:
        decoder._route = route
    return (torch.cat(paths["kernels"][2]), torch.cat(paths["plain"][2]),
            {"routing_flips": len(flips), "routing_flip_max_gap": max(flips, default=None)})


def _logits_check(lm, tokens, device, prefix, mean_rows=False, layered=False,
                  **batch_kw) -> dict:
    """Full-width agreement on one prefill: the kernels against the plain
    versions with f32 activations and an f32 KV cache (only the summation
    order differs: with an int8 cache a sum-order difference of one ulp can
    flip a rounding and move a K/V entry by a whole step), and the bf16
    serving path's (int8 or bf16 KV) distance from that f32 reference beside
    the bf16 plain path's: at most LOGITS_RATIO times it, in max |error|
    over the logits, or with mean_rows (a prefill whose logits are read at
    many rows) in mean |error| over them. Both paths' bf16 rounding is the
    same function's, so at a few thousand tokens the max over the logits of
    a row or of a few dozen rows is one extreme draw, whose ratio between
    the two paths spread 0.86-1.16 over ten prompts each of the llavanext
    and internvl phases (PERF.md, Findings) while their means agreed. layered:
    the f32 runs are built one layer at a time (_layered_f32_logits), for a
    model whose f32 copy would not fit beside it (its MoE layers' plain path
    routed as the kernel path, the f32 routing flips reported)."""
    import torch
    routing = {}
    with torch.no_grad():
        if layered:
            got32, ref32, routing = _layered_f32_logits(lm, tokens, device, **batch_kw)
        else:
            lm32 = _f32_lm(lm)
            ref32 = _plain_logits(lm32, tokens, device, **batch_kw)
            got32 = _prefill_logits(lm32, tokens, device, **batch_kw)
            del lm32
        got16 = _prefill_logits(lm, tokens, device, **batch_kw)
        plain16 = _plain_logits(lm, tokens, device, **batch_kw)
    scale32 = ref32.abs().max().item()
    err32 = (got32 - ref32).abs().max().item()
    err16_kernel = (got16 - ref32).abs().max().item()
    err16_plain = (plain16 - ref32).abs().max().item()
    mean16_kernel = (got16 - ref32).abs().mean().item()
    mean16_plain = (plain16 - ref32).abs().mean().item()
    bf16_ok = (mean16_kernel <= LOGITS_RATIO * mean16_plain if mean_rows else
               err16_kernel <= LOGITS_RATIO * max(err16_plain, 1e-3 * scale32))
    ok = (bool(torch.isfinite(got16).all() and torch.isfinite(got32).all())
          and err32 <= 1e-3 * scale32 and bf16_ok)
    return {"ok": ok, f"{prefix}_tokens": len(tokens), f"{prefix}_rows": ref32.shape[0],
            **{f"{prefix}_f32_{k}": v for k, v in routing.items()},
            f"{prefix}_f32_max_abs": scale32,
            f"{prefix}_f32_kernel_vs_plain_err": err32,
            f"{prefix}_bf16_kernel_vs_f32_err": err16_kernel,
            f"{prefix}_bf16_plain_vs_f32_err": err16_plain,
            f"{prefix}_bf16_ratio": err16_kernel / max(err16_plain, 1e-30),
            f"{prefix}_bf16_kernel_vs_f32_mean_err": mean16_kernel,
            f"{prefix}_bf16_plain_vs_f32_mean_err": mean16_plain,
            f"{prefix}_bf16_mean_ratio": mean16_kernel / max(mean16_plain, 1e-30),
            f"{prefix}_tolerance": "f32 activations and KV: 1e-3 x max|logit| (sum "
                                   f"order over the layers); bf16: {LOGITS_RATIO}x "
                                   "the plain path's distance from f32 ("
                                   + ("mean |error| over the rows)" if mean_rows
                                      else "max |error|)")}


def _profile_round(engine, reqs, name="serve_profile.json", rows_out=None) -> dict:
    """One more round under torch.profiler: device time by kernel and the
    device's busy share of the round's wall time (the profiler's own host
    overhead lengthens the wall, so the share is a lower bound). Whether the
    profiler sees the kernels inside replayed CUDA graphs: K3's kernels it
    counted against K3's launches in the round (replays included)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from hydrainfer_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.generate(reqs, timeout_s=600)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    k3_launches = launch_counts()["kv_writer"]
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0) or 0
        if us > 0 and "CUDA" in str(getattr(e, "device_type", "")):
            rows.append({"kernel": e.key[:120], "count": e.count, "ms": us / 1e3})
    rows.sort(key=lambda r: -r["ms"])
    if rows_out is not None:
        rows_out.extend(rows)
    busy_ms = sum(r["ms"] for r in rows)
    k3_seen = sum(r["count"] for r in rows if "kv_write_kernel" in r["kernel"])
    save(name, {"wall_s": wall, "device_busy_ms": busy_ms, "kernels": rows,
                "kv_writer_kernels_seen": k3_seen, "kv_writer_launches": k3_launches})
    if busy_ms == 0:
        return {"profile": "not measured (the profiler saw no device time)"}
    return {"profile_wall_s": wall, "profile_device_busy_share": busy_ms / 1e3 / wall,
            "profile_device_busy_ms": busy_ms,
            "profile_sees_graph_kernels": k3_seen >= k3_launches,
            "profile_kv_writer_seen_vs_launched": [k3_seen, k3_launches],
            "profile_top_kernels": [{k: r[k] for k in ("kernel", "count", "ms")}
                                    for r in rows[:8]]}


class KvWriteSplit:
    """K3's launches in a serving round, split by the step they ran in:
    decode (every query one token, max_q == 1) or prefill (chunks, alone or
    mixed with decodes), and by the rows (T) each launch wrote. It wraps the
    decoder's layer attention, which writes its layer's K/V through K3 on
    every rank, and GPT-2's step, which writes every layer's, and reads
    K3's own launch count around each call made outside a graph capture. A replayed graph
    calls no Python: each replay since `reset` of a node's graphs (all
    decode steps) adds the K3 launches its capture recorded, at its key's
    T."""

    def __init__(self):
        import torch
        from hydrainfer_tpu_torch.models import decoder, gpt2
        from hydrainfer_tpu_torch.ops.cuda import write_kv_pages
        # (module, function, its positional args -> (rows, max_q))
        targets = [(decoder, "_layer_attention", lambda a: (a[0].shape[0], a[5])),
                   (gpt2, "gpt2_forward", lambda a: (a[3].token_ids.shape[0], a[5]))]
        self.saved = [(mod, name, getattr(mod, name)) for mod, name, _ in targets]
        self.reset()

        def wrap(fn, geometry):
            def spy(*args, **kw):
                before = write_kv_pages.launches
                out = fn(*args, **kw)
                if not torch.cuda.is_current_stream_capturing():
                    n, max_q = geometry(args)
                    rows = self.rows["decode" if max_q == 1 else "prefill"]
                    rows[n] = rows.get(n, 0) + write_kv_pages.launches - before
                return out
            return spy

        for (mod, name, geometry), (_, _, fn) in zip(targets, self.saved):
            setattr(mod, name, wrap(fn, geometry))

    def reset(self, graphs=None) -> None:
        self.rows = {"decode": {}, "prefill": {}}
        self.graphs = graphs
        self.replays0 = ({key: g.replays for key, g in graphs.graphs.items()}
                         if graphs is not None else {})

    def restore(self) -> None:
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)

    def _rows(self) -> dict:
        rows = {form: dict(r) for form, r in self.rows.items()}
        if self.graphs is not None:
            for (dims, _), g in self.graphs.graphs.items():
                n = (g.replays - self.replays0.get((dims, _), 0)) * g.launches.get(
                    "kv_writer", 0)
                if n:
                    rows["decode"][dims.T] = rows["decode"].get(dims.T, 0) + n
        return rows

    def counts(self) -> dict:
        """{"kv_writer:decode": n, "kv_writer:prefill": m}, beside the
        wrappers' launch counts."""
        return {f"kv_writer:{form}": sum(r.values()) for form, r in self._rows().items()}

    def report(self) -> dict:
        return {form: {"launches": sum(r.values()),
                       "launches_by_rows": {str(t): n for t, n in sorted(r.items())}}
                for form, r in self._rows().items()}


class GraphRounds:
    """The `graphs` report of a serving phase: the keys its engine captured
    at boot and in the warm-up round (each with the kernel launches one
    replay runs), with the seconds spent capturing, the
    keys captured and the replays in the measured round (no key may be
    captured there: the warm-up round has met every one), and the graph
    pool's bytes against the headroom an auto-sized KV pool leaves one
    resident model (0.1 of the usable free memory, cluster/node.py)."""

    def __init__(self, engine, free_bytes: int):
        self.graphs = engine.node.fill_executor.graphs
        self.headroom = int(0.1 * engine.node.config.hbm_utilization * free_bytes)
        self.boot = (self.graphs.captures, self.graphs.capture_s)

    def start_measured(self) -> None:
        self.warm = (self.graphs.captures, self.graphs.capture_s)
        self.replays0 = self.graphs.replays

    def end_measured(self) -> None:
        self.measured = (self.graphs.captures - self.warm[0],
                         self.graphs.replays - self.replays0)

    def report(self) -> dict:
        g = self.graphs
        pool = g.pool_bytes()
        return {"keys_captured_at_boot": self.boot[0], "capture_s_at_boot": self.boot[1],
                "keys_captured_in_warmup_round": self.warm[0] - self.boot[0],
                "capture_s": g.capture_s, "keys_captured_in_measured_round": self.measured[0],
                "replays_in_measured_round": self.measured[1], "pool_bytes": pool,
                "auto_sizing_headroom_bytes": self.headroom,
                # each key's kernel launches a replay runs
                "keys": {f"T={d.T} S={d.S} MB={d.MB} mrope={d.mrope} n_steps={n}"
                         + (" sampling" if d.sampling else "")
                         + (f" spec={d.spec}" if d.spec else ""): gr.launches
                         for (d, n), gr in sorted(g.graphs.items(), key=str)}}

    def ok(self) -> bool:
        return (self.measured[0] == 0 and self.measured[1] > 0
                and self.graphs.pool_bytes() <= self.headroom)


def _eager_round(factory, dev, n_blocks, token_budget, reqs, ref_outs, phase,
                 profiled=True) -> dict:
    """The serve phase's A/B: a second engine on the same model, with
    cuda_graphs off and the same boot warm-up (the same key floors), serves a
    warm-up round, the measured round's requests again and (with
    `profiled`) a profiled round. Its greedy tokens must equal the graphs-on
    round's. Its own prompts come from their own generator, so the phase's
    later checks draw the data they drew without this round."""
    import numpy as np
    import torch
    from hydrainfer_tpu_torch.request import Request, SamplingParameters
    n, max_tokens = len(reqs), reqs[0].sampling_params.max_tokens
    rng = np.random.default_rng(SEED + 1)
    engine = _engine(factory, dev, n, 16, n_blocks, token_budget, cuda_graphs=False)
    engine.generate(_requests(rng, n, len(reqs[0].prompt), max_tokens, "warm_eager"),
                    timeout_s=600)
    again = [Request(request_id=f"eager{i}", prompt=r.prompt,
                     sampling_params=SamplingParameters(max_tokens=max_tokens,
                                                        ignore_eos=True))
             for i, r in enumerate(reqs)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = engine.generate(again, timeout_s=600)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    profiled = (_profile_round(engine, _requests(rng, n, len(reqs[0].prompt), max_tokens,
                                                 "prof_eager"),
                               f"{phase}_eager_profile.json") if profiled else {})
    ttfts = sorted(o.ttft for o in outs)
    return {"cuda_graphs": False,
            "tokens_per_s": sum(len(o.output_token_ids) for o in outs) / elapsed,
            "elapsed_s": elapsed, "p50_ttft_s": ttfts[len(ttfts) // 2], "ttfts_s": ttfts,
            "tokens_identical_to_graphs_round": [o.output_token_ids for o in outs]
            == [o.output_token_ids for o in ref_outs],
            **{k: v for k, v in profiled.items() if k != "profile_top_kernels"}}


def _serve_logits(lm, rng, dev) -> dict:
    """The serve phase's logits check: one 64-token prefill (_logits_check)."""
    return _logits_check(lm, [int(t) for t in rng.integers(10, 120, size=64)], dev,
                         "prefill_logits")


def phase_serve(arch="llava-7b-lm", dev="cuda", n_requests=8, prompt_len=128,
                max_tokens=32, token_budget=256, phase="serve", must_run=SERVE_KERNELS,
                must_not_run=(), eager_round=True, factory=None, logits_fn=_serve_logits,
                extra_fn=None, eager_profile=True, window=16,
                precision=("int8", "int8 (scale 0.05)")) -> tuple:
    """Text serving of `arch` (int8 weights, int8 KV at 0.05; `factory`
    where given, else a RandomWeightFactory from the seed, its weights and
    KV cache as `precision` says) through OfflineEngine with CUDA graphs on:
    boot (the decode warm-up), a warm-up round, the measured round, a
    profiled round. Every kernel of must_run has to launch in the measured
    round, and none of must_not_run; a `window`-step window must run (1: a
    model without fused windows); the round must replay graphs and capture
    none. With eager_round, the same model then
    serves the measured round's requests with graphs off (_eager_round;
    profiled unless eager_profile is off). logits_fn(lm, rng, dev) holds the
    logits; extra_fn(engine, graphs, lm),
    run last, adds its fields (and its "ok") to the result."""
    import numpy as np
    import torch
    from hydrainfer_tpu_torch.engine import executor as ex
    from hydrainfer_tpu_torch.models.random_init import RandomWeightFactory
    from hydrainfer_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    dev = torch.device(dev)
    t0 = time.perf_counter()
    if factory is None:
        factory = RandomWeightFactory(arch, dtype=torch.bfloat16, quantization="int8",
                                      kv_scale=0.05, device=dev, seed=SEED)
    lm = factory.getLanguageModel()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_blocks = max(256, 2 * n_requests * (prompt_len + max_tokens) // 16)
    free = torch.cuda.mem_get_info(dev)[0]
    t0 = time.perf_counter()
    engine = _engine(factory, dev, n_requests, 16, n_blocks, token_budget)
    boot_s = time.perf_counter() - t0
    graphs = GraphRounds(engine, free)
    rng = np.random.default_rng(SEED)

    windows = []
    orig = ex.FillExecutor._multi_step_window

    def spy(self, batch, n_steps):
        n, ks = orig(self, batch, n_steps)
        windows.append(n)
        return n, ks

    ex.FillExecutor._multi_step_window = spy
    k3 = KvWriteSplit()
    try:
        # warm-up round (cuBLAS and allocator set-up, the keys the boot
        # warm-up did not meet), then the measured round
        t_rounds = time.perf_counter()
        engine.generate(_requests(rng, n_requests, prompt_len, max_tokens, "warm"),
                        timeout_s=600)
        windows.clear()
        reqs = _requests(rng, n_requests, prompt_len, max_tokens, "serve")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        k3.reset(graphs.graphs)
        graphs.start_measured()
        t1 = time.perf_counter()
        outs = engine.generate(reqs, timeout_s=600)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t1
        graphs.end_measured()
        counts = {**launch_counts(), **k3.counts()}
        k3_split = k3.report()
        peak = torch.cuda.max_memory_allocated()
        measured_windows = list(windows)
        profiled = _profile_round(engine, _requests(rng, n_requests, prompt_len,
                                                    max_tokens, "prof"),
                                  f"{phase}_profile.json")
        parts = {"graphs_rounds": time.perf_counter() - t_rounds}
        t1 = time.perf_counter()
        eager = (_eager_round(factory, dev, n_blocks, token_budget, reqs, outs, phase,
                              eager_profile) if eager_round else None)
        parts["eager_round"] = time.perf_counter() - t1
    finally:
        ex.FillExecutor._multi_step_window = orig
        k3.restore()

    n_tokens = [len(o.output_token_ids) for o in outs]
    vocab = factory.cfg.vocab_size
    tokens_ok = all(n == max_tokens for n in n_tokens) and all(
        0 <= t < vocab for o in outs for t in o.output_token_ids)
    ttfts = sorted(o.ttft for o in outs)

    t1 = time.perf_counter()
    logits = logits_fn(lm, rng, dev)
    parts["logits"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    extra = extra_fn(engine, graphs, lm) if extra_fn is not None else {}
    parts["extra"] = time.perf_counter() - t1
    windows = measured_windows
    # the llava text path runs K1-K4 (K5 is the ViT's, K6 the MLA path's);
    # the MLA path runs K6, K3 and K4, and never K1 or K2
    # both popped before the test: a short-circuit would leave an "ok" behind
    # that the result's spread would then write over the phase's
    logits_ok, extra_ok = logits.pop("ok"), extra.pop("ok", True)
    ok = (tokens_ok and logits_ok and extra_ok and window in windows
          and graphs.ok() and all(counts[k] > 0 for k in must_run)
          and all(counts[k] == 0 for k in must_not_run)
          and (eager is None or eager["tokens_identical_to_graphs_round"]))
    result = {"phase": phase, "ok": bool(ok), "gpu": gpu_name_and_limit(),
              "arch": arch, "weights": precision[0], "kv_cache": precision[1],
              "n_requests": n_requests, "prompt_len": prompt_len,
              "max_tokens": max_tokens, "token_budget": token_budget,
              "tokens_per_request": n_tokens, "tokens_per_s": sum(n_tokens) / elapsed,
              "elapsed_s": elapsed, "p50_ttft_s": ttfts[len(ttfts) // 2],
              "ttfts_s": ttfts,
              "weight_init_s": init_s, "boot_s": boot_s,
              "param_bytes": factory.param_bytes(),
              "fused_windows": sorted(set(windows)),
              f"n_k{window}_windows": windows.count(window), "launches": counts,
              "kv_writer_launches": k3_split, "graphs": graphs.report(), **logits,
              "peak_memory_bytes": peak, **profiled,
              **({"eager_round": eager} if eager is not None else {}), **extra,
              "parts_s": parts}
    return result, counts


def phase_mla(dev="cuda") -> tuple:
    """mla-2b-lm at full width (27 layers, depth not cut), seeded random
    weights: bf16 with int8 o_proj/gate_up/down/lm_head, int8 latent KV at
    scale 0.05; 32 requests x 128-token prompts x MLA_TOKENS greedy tokens,
    token budget 2048, block size 16, K=16 windows."""
    return phase_serve(MLA_ARCH, dev, MLA_REQUESTS, MLA_PROMPT, MLA_TOKENS, 2048,
                       phase="mla", must_run=MLA_KERNELS,
                       must_not_run=("mha_decode", "paged_attention"), eager_round=False)


# ------------------------------------------------------------ phase: quant

def _decode_step(graphs, lm, mode: str) -> dict:
    """The decode step's device ms (the widest K = 16 window's graph replay
    over 16) beside its byte bound: the weights a step reads as stored (the
    layers' four projections, int4's group scales included, and the
    lm_head, at `mode`; the embedding gather, the norms and the KV not
    counted)."""
    from hydrainfer_tpu_torch.models.random_init import quant_matmul_forms, quant_weight_bytes
    keys = [(d, n, g) for (d, n), g in graphs.graphs.graphs.items() if n == 16]
    d, n, g = max(keys, key=lambda x: x[0].S)
    forms = quant_matmul_forms(lm.cfg, mode)
    layer = sum(quant_weight_bytes(*f) for k, f in forms.items() if k != "lm_head")
    n_bytes = lm.cfg.n_layers * layer + quant_weight_bytes(*forms["lm_head"])
    return {"decode_step_device_ms": _replay_ms(g.graph, replays=5) / n,
            "decode_step_key": f"T={d.T} S={d.S}",
            "decode_step_bound_ms": 1e3 * n_bytes / HBM_BYTES_PER_S,
            "decode_step_bound_bytes": n_bytes,
            "quantized_forms": {k: {"K": f[0], "N": f[1], "fmt": f[2], "group": f[3]}
                                for k, f in forms.items()}}


def _quant_extra(mode: str, factory, dev):
    """The quant phase's extra_fn for one mode: the decode step
    (_decode_step), the weight bytes, and a short round
    (QUANT_EAGER_REQUESTS x QUANT_EAGER_TOKENS) served by this engine from
    its graphs and by a second engine on the same model with graphs off:
    the greedy tokens must be identical."""
    import numpy as np
    from hydrainfer_tpu_torch.request import Request, SamplingParameters

    def extra(engine, graphs, lm):
        step = _decode_step(graphs, lm, mode)
        rng = np.random.default_rng(SEED + 3)
        prompts = [r.prompt for r in _requests(rng, QUANT_EAGER_REQUESTS, 128,
                                               QUANT_EAGER_TOKENS, "q")]

        def short(eng, tag):
            reqs = [Request(request_id=f"{tag}{i}", prompt=p,
                            sampling_params=SamplingParameters(
                                max_tokens=QUANT_EAGER_TOKENS, ignore_eos=True))
                    for i, p in enumerate(prompts)]
            return [o.output_token_ids for o in eng.generate(reqs, timeout_s=600)]

        replays0 = graphs.graphs.replays
        graphed = short(engine, "qg")
        replayed = graphs.graphs.replays - replays0
        eager_engine = _engine(factory, dev, 8, 16, 256, PATH_SHAPES["serve"]["budget"],
                               cuda_graphs=False)
        eager = short(eager_engine, "qe")
        del eager_engine
        return {"ok": graphed == eager and replayed > 0
                and all(len(t) == QUANT_EAGER_TOKENS for t in graphed),
                **step, "weight_bytes": factory.param_bytes(),
                "short_round": f"{QUANT_EAGER_REQUESTS} x {QUANT_EAGER_TOKENS} tokens",
                "short_round_graph_replays": replayed,
                "short_round_tokens_identical_graphs_off": graphed == eager}
    return extra


def phase_quant(dev="cuda") -> tuple:
    """llava-7b-lm's language tower at full width and depth (32 layers,
    seeded random weights quantized layer by layer as they are built) at
    int4 (group 128; the lm_head int8) and then at fp8 (e4m3, per column),
    int8 KV at 0.05, each served as the serve phase serves int8: 8 requests x
    128-token prompts x 32 tokens, budget 256, K = 16 windows from CUDA
    graphs, a warm-up, a measured and a profiled round. Checks per mode:
    every request finishes with its tokens; K1-K3 and K4's form for the mode
    launch in the measured round, and K4's int8 form only for the lm_head
    (int4: 4 x 32 int4 launches for each int8 one; fp8: none); one 64-token
    prefill's logits through the kernels against the plain versions
    (_logits_check); a short round from the graphs equals the same round
    with graphs off. Reports tokens/s, p50 TTFT, the decode step's device ms
    beside its byte bound, peak memory and weight bytes."""
    import gc
    import torch
    from hydrainfer_tpu_torch.models.random_init import ARCH_CONFIGS, RandomWeightFactory
    n_proj = 4 * ARCH_CONFIGS[QUANT_ARCH].n_layers
    result, counts, ok = {"phase": "quant", "gpu": gpu_name_and_limit()}, {}, True
    for mode in QUANT_MODES:
        factory = RandomWeightFactory(QUANT_ARCH, dtype=torch.bfloat16, quantization=mode,
                                      kv_scale=0.05, device=torch.device(dev), seed=SEED)
        kernel = f"quant_matmul_{mode}"
        res, c = phase_serve(
            QUANT_ARCH, dev, phase=f"quant_{mode}", factory=factory,
            must_run=("mha_decode", "paged_attention", "kv_writer", kernel)
            + (("quant_matmul",) if mode == "int4" else ()),
            must_not_run=("quant_matmul",) if mode == "fp8" else (),
            eager_round=False, extra_fn=_quant_extra(mode, factory, dev),
            precision=(f"{mode} (" + ("group 128, lm_head int8" if mode == "int4"
                                      else "e4m3, per column") + ")", "int8 (scale 0.05)"))
        # K4's int8 form serves the lm_head alone: one call a forward step
        # beside the 4 x 32 projections of the mode's form
        head_ok = (c[kernel] == n_proj * c["quant_matmul"] if mode == "int4"
                   else c["quant_matmul"] == 0)
        res["lm_head_only_on_int8"] = head_ok
        res["ok"] = bool(res["ok"] and head_ok)
        ok = ok and res["ok"]
        result[mode] = res
        counts[mode] = c
        del factory
        gc.collect()
        torch.cuda.empty_cache()
    result["ok"] = bool(ok)
    save("quant.json", result)
    return result, counts


# ------------------------------------------------------------ phase: quality

def check_quality_k4(gen, dev) -> list:
    """K4 for the lm_head at every position of a 512-token sequence (M 512,
    K 4096, N 32064, f32 out), llava-7b-lm's, in its int8, int4 (group 128)
    and fp8 forms: the weight N(0, 1/K) quantized on the card by the port's
    quantize functions, each form held to its plain version, timed eager and
    from a CUDA graph (one weight, 66-131 MB, is past the 50 MB L2) beside
    its operation bound and torch.mm on the weight dequantized to bf16
    outside the timed call. One row a form, path "quality"."""
    import torch
    from hydrainfer_tpu_torch.models.random_init import ARCH_CONFIGS, quant_weight_bytes
    from hydrainfer_tpu_torch.ops.cuda import quant_matmul as qmm
    from hydrainfer_tpu_torch.ops.quant import (dequantize, quantize_fp8, quantize_int4,
                                                quantize_int8)
    cfg = ARCH_CONFIGS[QUALITY_ARCH]
    M, K, N = QUALITY_FULL_T, cfg.hidden_size, cfg.vocab_size
    forms = {"int8": (quantize_int8, "quant_matmul", qmm.quant_matmul_int8,
                      qmm.quant_matmul_int8_plain),
             "int4": (quantize_int4, "quant_matmul_int4", qmm.quant_matmul_int4,
                      qmm.quant_matmul_int4_plain),
             "fp8": (quantize_fp8, "quant_matmul_fp8", qmm.quant_matmul_fp8,
                     qmm.quant_matmul_fp8_plain)}
    x = torch.randn((M, K), generator=gen).to(dev, torch.bfloat16)
    w = (torch.randn((K, N), generator=gen) / math.sqrt(K)).to(dev)
    rows = []
    for fmt, (quant, name, kernel, plain) in forms.items():
        qt = quant(w)
        args = (qt.q, qt.scale) if fmt == "int8" else (qt.q, qt.scale, qt.group)
        got = kernel(x, *args, out_dtype=torch.float32)
        ref = plain(x, *args, out_dtype=torch.float32)
        err = (got - ref).abs().max().item()
        scale_ref = max(1.0, ref.abs().max().item())
        call = lambda: kernel(x, *args, out_dtype=torch.float32)  # noqa: E731
        w_bf = dequantize(qt, torch.bfloat16)
        library, lib = _fastest({
            "torch.mm, weight dequantized to bf16 outside the timed call": (
                lambda: lambda: torch.mm(x, w_bf), lambda o: o)}, ref, 1e-2 * scale_ref)
        w_bytes = quant_weight_bytes(K, N, fmt, qt.group)
        b_ms, b_by = bound_ms(M * K * 2 + w_bytes + M * N * 4, 2.0 * M * K * N)
        p = qmm.plan(M, K, N, fmt)
        rows.append({"name": name, "path": "quality", "ok": err <= 1e-4 * scale_ref,
                     "max_abs_err": err, "tolerance": "1e-4 x max|plain| (f32 logits)",
                     "shape": f"{QUALITY_ARCH} lm_head at every position: M={M} x K={K} x "
                              f"N={N}, {fmt}" + (f" g{qt.group}" if qt.group else
                                                 ", per column") + f", f32 out ({p.form}, "
                              f"{p.splits} slices)",
                     "ms": time_ms(call), "graph_ms": graph_ms(call),
                     "plain_ms": time_ms(lambda: plain(x, *args, out_dtype=torch.float32),
                                         iters=5),
                     "library_ms": library[lib]["ms"] if lib else None,
                     "library_graph_ms": library[lib].get("graph_ms") if lib else None,
                     "library": lib, "bound_ms": b_ms, "bound_by": b_by,
                     "weight_bytes": w_bytes})
        del qt, w_bf
    return rows


def check_quality_k2(gen, dev) -> dict:
    """K2 on a lone 512-row prefill at llava-7b-lm's heads over a bf16 cache
    (check_paged_mixed at path "quality"), and the same pages read through
    the all-position batch's geometry (perplexity.make_full_logit_batch: 512
    sequences of which one is real, each with kv_len 512): its rows must
    equal the lone sequence's."""
    import torch
    from hydrainfer_tpu_torch.ops.cuda.paged_attention import paged_attention_varlen
    row = check_paged_mixed(gen, dev, "quality", QUALITY_SHAPES["mixed"], QUALITY_FULL_T,
                            f"one {QUALITY_FULL_T}-token prefill (the quality phase's "
                            "all-position batch)")
    cfg = _arch_cfg("quality")
    T, H, kvh, D = QUALITY_FULL_T, cfg.n_qo_heads, cfg.n_kv_heads, cfg.head_dim
    pages, tables, kv_lens, cu, ns = _paged_case(gen, QUALITY_SHAPES["mixed"],
                                                 _pool_blocks(QUALITY_SHAPES["mixed"], 16),
                                                 16, kvh, D, None, dev)
    q = torch.randn((T, H, D), generator=gen).to(dev, torch.bfloat16)
    lone = paged_attention_varlen(q, pages, kv_lens, tables, cu, ns, 1 / math.sqrt(D))
    i32 = dict(dtype=torch.int32, device=dev)
    padded = paged_attention_varlen(
        q, pages, torch.full((T,), T, **i32), tables.expand(T, -1).contiguous(),
        torch.cat([torch.zeros(1, **i32), torch.full((T,), T, **i32)]), ns, 1 / math.sqrt(D))
    diff = (padded.float() - lone.float()).abs().max().item()
    row.update({"padded_geometry_max_diff": diff,
                "padded_geometry_ms": time_ms(lambda: paged_attention_varlen(
                    q, pages, torch.full((T,), T, **i32), tables.expand(T, -1).contiguous(),
                    torch.cat([torch.zeros(1, **i32), torch.full((T,), T, **i32)]), ns,
                    1 / math.sqrt(D)))})
    row["ok"] = bool(row["ok"] and diff == 0.0)
    return row


def _quality_family(family: str, root: str, dev) -> dict:
    """One of the quant_quality script's checkpoints built, trained on the
    card for QUALITY_TRAIN_STEPS steps and evaluated in its six CONFIGS on
    its held-out sequences twice: through the kernels, then through the
    plain versions on the same card. Checks per config: the kernel run's NLL
    within QUALITY_NLL_NATS of the plain run's, top-1 agreement between the
    two runs' logits at least QUALITY_TOP1, and the config's K4 form
    launched (int8: the int8 form; int4: the int4 form; fp8: the fp8 form;
    none other than int8 for the lm_head) and, for the MLA checkpoint, K6."""
    import numpy as np
    from hydrainfer_tpu_torch.evaluation import quant_quality as qq
    from hydrainfer_tpu_torch.ops.cuda import launch_counts
    llama = family == "llama"
    t0 = time.perf_counter()
    path = qq.make_llama_ckpt(root) if llama else qq.make_mla_ckpt(root)
    vocab, seq_len, seed, T = (2048, 128, 0, 64) if llama else (256, 64, 1, 48)
    sampler = qq.markov_sampler(vocab, seed=7 if llama else 9)
    loss = qq.train_ckpt(path, sampler, QUALITY_TRAIN_STEPS, T=T, device=dev)
    train_s = time.perf_counter() - t0
    seqs = qq.eval_sequences(QUALITY_SEQS, seq_len, vocab, seed, sampler)
    kern, plain, launches, checks = {}, {}, {}, {}
    t0 = time.perf_counter()
    for label, quant, kv_int8 in qq.CONFIGS:
        before = launch_counts()
        kern[label] = qq.all_position_logits(path, quant, kv_int8, seqs, device=dev)
        after = launch_counts()
        launches[label] = {k: after[k] - before[k] for k in after if after[k] > before[k]}
        with _Plain():
            plain[label] = qq.all_position_logits(path, quant, kv_int8, seqs, device=dev)
    eval_s = time.perf_counter() - t0
    table_k, table_p = qq.table(kern, seqs), qq.table(plain, seqs)
    attention = "paged_attention" if llama else "paged_attention_latent"
    for label, quant, kv_int8 in qq.CONFIGS:
        n = launches[label]
        form = {"int8": "quant_matmul", "int4": "quant_matmul_int4",
                "fp8": "quant_matmul_fp8"}.get(quant)
        others = {"quant_matmul", "quant_matmul_int4", "quant_matmul_fp8"} - {form}
        if quant == "int4":
            others.discard("quant_matmul")        # the int4 mode's lm_head is int8
        top1 = float((kern[label].argmax(-1) == plain[label].argmax(-1)).mean())
        dnll = abs(table_k[label]["nll"] - table_p[label]["nll"])
        checks[label] = {
            "nll_within": dnll <= QUALITY_NLL_NATS, "kernel_vs_plain_nll": dnll,
            "top1_kernel_vs_plain": top1, "top1_ok": top1 >= QUALITY_TOP1,
            "form_launched": form is None or n.get(form, 0) > 0,
            "no_other_form": all(n.get(k, 0) == 0 for k in others),
            "attention_launched": n.get(attention, 0) > 0 and n.get("kv_writer", 0) > 0,
            "launches": n}
    ok = all(c[k] for c in checks.values()
             for k in ("nll_within", "top1_ok", "form_launched", "no_other_form",
                       "attention_launched"))
    total = {}
    for n in launches.values():
        for k, v in n.items():
            total[k] = total.get(k, 0) + v
    print(f"## {family} (kernels)\n{qq.markdown(table_k)}\n## {family} (plain versions)\n"
          f"{qq.markdown(table_p)}", flush=True)
    return {"ok": bool(ok), "path": path, "final_loss": loss, "train_s": train_s,
            "eval_s": eval_s, "eval": f"{QUALITY_SEQS} held-out sequences x {seq_len}",
            "table_kernels": table_k, "table_plain": table_p, "checks": checks,
            "launches": total, "logits_finite": bool(np.isfinite(
                np.stack(list(kern.values()))).all())}


def _quality_dumps(path: str, dev) -> dict:
    """The correctness dumps of the trained tiny Llama (a word-level
    tokenizer saved beside it): on the card at bf16, int8, int4 and fp8, each
    compared with the card's bf16 dump, and the port's CPU dump at bf16,
    which must equal the card's or first differ at a near tie (_near_tie)."""
    import torch
    from hydrainfer_tpu_torch.evaluation import test_correctness as tc
    from hydrainfer_tpu_torch.models.factory import ModelFactoryConfig, getModelFactory
    from hydrainfer_tpu_torch.request import Request, SamplingParameters
    tc.save_word_tokenizer(path, 2048)
    dumps, seconds = {}, {}
    for label, quant, device in (("bf16", "none", dev), ("int8", "int8", dev),
                                 ("int4", "int4", dev), ("fp8", "fp8", dev),
                                 ("cpu_bf16", "none", "cpu")):
        t0 = time.perf_counter()
        dumps[label] = tc.run_generate(path, QUALITY_DUMP_PROMPTS, QUALITY_DUMP_TOKENS,
                                       dtype="bf16", quantization=quant, device=device)
        seconds[label] = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
    compare = {label: tc.compare_dumps(dumps["bf16"], d) for label, d in dumps.items()
               if label != "bf16"}
    factory = getModelFactory(ModelFactoryConfig(path=path, dtype="bf16"), device=dev)
    reqs = [Request(request_id=i, prompt=d["prompt"],
                    sampling_params=SamplingParameters(max_tokens=QUALITY_DUMP_TOKENS,
                                                       ignore_eos=True))
            for i, d in enumerate(dumps["bf16"])]
    tie = _near_tie(factory.getLanguageModel(), factory.getTokenizer(), reqs,
                    [d["output_token_ids"] for d in dumps["bf16"]],
                    [d["output_token_ids"] for d in dumps["cpu_bf16"]], dev)
    full = all(len(d["output_token_ids"]) == QUALITY_DUMP_TOKENS
               for dump in dumps.values() for d in dump)
    return {"ok": bool(tie["ok"] and full), "dumps": f"{QUALITY_DUMP_PROMPTS} prompts x "
            f"{QUALITY_DUMP_TOKENS} tokens, greedy, ignore_eos", "seconds": seconds,
            "compare_vs_card_bf16": compare, "card_vs_cpu_near_tie": tie,
            "every_dump_full": full}


def _span_and_busy_ms(fn) -> dict:
    """One eager call of fn: its span on the card's clock (CUDA events: the
    device's idle gaps while the host launches included) and the device time
    of its kernels (torch.profiler; 0 where the profiler sees none)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    busy = sum(getattr(e, "self_device_time_total", 0) or 0 for e in prof.key_averages())
    return {"span_ms": start.elapsed_time(end), "device_busy_ms": busy / 1e3}


def _quality_full_width(dev) -> tuple:
    """llava-7b-lm at full width from one seeded bf16 tree, quantized in turn
    to int8, int4 (group 128, the lm_head int8) and fp8, each copy freed
    before the next: the six CONFIGS' all-position logits over
    QUALITY_FULL_SEQS sequences of QUALITY_FULL_T tokens, each config's KL
    and top-1 agreement against bf16 (random weights: near-zero margins, so
    no ordering between formats is checked), the span and the kernels'
    device time of one all-position prefill (_span_and_busy_ms), the int4 config's logits on one sequence against
    the plain versions (_logits_check), and getModelParamsCount() of the
    bf16 tree against param_count()."""
    import numpy as np
    import torch
    from hydrainfer_tpu_torch.evaluation import quant_quality as qq
    from hydrainfer_tpu_torch.evaluation.perplexity import all_logits
    from hydrainfer_tpu_torch.models.llama import LlamaForCausalLM
    from hydrainfer_tpu_torch.models.random_init import (ARCH_CONFIGS, RandomWeightFactory,
                                                         init_decoder_weights)
    from hydrainfer_tpu_torch.ops.cuda import launch_counts
    cfg = ARCH_CONFIGS[QUALITY_ARCH]
    t0 = time.perf_counter()
    w = init_decoder_weights(cfg, SEED, torch.bfloat16, "none", dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    factory = RandomWeightFactory(QUALITY_ARCH, device=dev, weights=w)
    counted = factory.getModelParamsCount().language_model_params
    logical = factory.param_count()
    lcfg = factory.getLanguageModelConfig()
    rng = np.random.default_rng(SEED + 11)
    seqs = rng.integers(10, cfg.vocab_size, size=(QUALITY_FULL_SEQS, QUALITY_FULL_T))
    logits, prefill_ms, launches, res = {}, {}, {}, {}
    for label, quant, kv_int8 in qq.CONFIGS:
        lm = LlamaForCausalLM(w, cfg, quant, kv_scale=0.05 if kv_int8 else None)
        cache_dtype = torch.int8 if kv_int8 else torch.bfloat16
        before = launch_counts()
        out = [all_logits(lm, lcfg, [int(t) for t in seq], 16, cache_dtype).cpu().numpy()
               for seq in seqs]
        after = launch_counts()
        launches[label] = {k: after[k] - before[k] for k in after if after[k] > before[k]}
        logits[label] = np.stack(out)
        prefill_ms[label] = _span_and_busy_ms(
            lambda: all_logits(lm, lcfg, [int(t) for t in seqs[0]], 16, cache_dtype))
        if label == "int4":
            res["int4_logits_check"] = _logits_check(lm, [int(t) for t in seqs[0]], dev,
                                                     "full_int4")
        del lm
        gc.collect()
        torch.cuda.empty_cache()
    del w, factory
    gc.collect()
    torch.cuda.empty_cache()
    table = qq.table(logits, seqs)
    print(f"## {QUALITY_ARCH} (random weights, {QUALITY_FULL_SEQS} x {QUALITY_FULL_T})\n"
          f"{qq.markdown(table)}", flush=True)
    check = res["int4_logits_check"]
    ok = bool(check["ok"] and counted == logical
              and np.isfinite(np.stack(list(logits.values()))).all())
    total = {}
    for n in launches.values():
        for k, v in n.items():
            total[k] = total.get(k, 0) + v
    return {"ok": ok, "weight_init_s": init_s, "table": table,
            "kl_and_top1_vs_bf16": {k: {"mean_kl_nats": v["mean_kl_nats"],
                                        "top1_agreement": v["top1_agreement"]}
                                    for k, v in table.items()},
            "all_position_prefill_ms": prefill_ms, "launches": launches,
            "params_counted_bf16_tree": counted, "param_count": logical,
            "params_equal": counted == logical, **check}, total


def phase_quality(dev="cuda") -> tuple:
    """The quality scripts on the card: (a) quant_quality's tiny Llama and
    DeepSeek-V3 MLA checkpoints, trained on the card, through the port in
    its six configs with the kernels and with the plain versions
    (_quality_family); (c) the correctness dumps of the trained Llama
    (_quality_dumps) and model_params for every ARCH_CONFIGS entry from
    shapes alone; (b) llava-7b-lm at full width in the six configs
    (_quality_full_width). Returns the phase's result and the launch counts
    of the kernel runs of (a) and (b), the phase's main path (the plain runs
    count nothing, and the timed kernel rows run after)."""
    import shutil
    import tempfile
    import torch
    from hydrainfer_tpu_torch.evaluation import model_params
    from hydrainfer_tpu_torch.models.random_init import ARCH_CONFIGS, RandomWeightFactory
    from hydrainfer_tpu_torch.ops.cuda import reset_launch_counts
    dev = torch.device(dev)
    result, parts, counts = {"phase": "quality", "gpu": gpu_name_and_limit()}, {}, {}
    root = tempfile.mkdtemp(prefix="quality_")
    try:
        reset_launch_counts()
        for family in ("llama", "mla"):
            t0 = time.perf_counter()
            result[family] = _quality_family(family, root, dev)
            parts[family] = time.perf_counter() - t0
            for k, v in result[family]["launches"].items():
                counts[k] = counts.get(k, 0) + v
        t0 = time.perf_counter()
        result["correctness"] = _quality_dumps(result["llama"]["path"], dev)
        parts["correctness"] = time.perf_counter() - t0
        result["model_params"] = {
            name: model_params.table_for(RandomWeightFactory(name, device="meta"))
            for name in ARCH_CONFIGS}
        t0 = time.perf_counter()
        result["full_width"], full_counts = _quality_full_width(dev)
        parts["full_width"] = time.perf_counter() - t0
        for k, v in full_counts.items():
            counts[k] = counts.get(k, 0) + v
        gen = torch.Generator().manual_seed(SEED)
        t0 = time.perf_counter()
        rows = check_quality_k4(gen, dev) + [check_quality_k2(gen, dev)]
        parts["kernel_rows"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)
    result["parts_s"] = parts
    result["launches"] = counts
    result["kernel_rows"] = {f"{_launch_key(r)}@quality": {
        "ok": r["ok"], "max_abs_err": r["max_abs_err"], "ms": r["ms"]} for r in rows}
    save("quality_kernels.json", rows)
    result["ok"] = bool(all(result[k]["ok"] for k in ("llama", "mla", "correctness",
                                                      "full_width"))
                        and all(r["ok"] for r in rows))
    save("quality.json", result)
    return result, counts, rows


# ------------------------------------------------------- phases: spec, sample

# four lookup-friendly requests (at most spec_max_batch): a seeded 32-token
# sequence repeated four times, 128 tokens each
SPEC_REQUESTS, SPEC_PERIOD, SPEC_TOKENS = 4, 32, 128
SAMPLE_REQUESTS, SAMPLE_TOKENS = 8, 64
SAMPLE_CONTROLS = dict(temperature=0.8, top_k=40, top_p=0.95)
_LLAVA = {}


def _llava_factory(dev):
    """llava-7b-lm at full width (int8 weights, int8 KV at 0.05), seeded: one
    weight init shared by the spec and sample phases."""
    import torch
    from hydrainfer_tpu_torch.models.random_init import RandomWeightFactory
    if "factory" not in _LLAVA:
        _LLAVA["factory"] = RandomWeightFactory(
            "llava-7b-lm", dtype=torch.bfloat16, quantization="int8", kv_scale=0.05,
            device=dev, seed=SEED)
    return _LLAVA["factory"]


def _spec_requests(rng, tag):
    from hydrainfer_tpu_torch.request import Request, SamplingParameters
    letters = list("abcdefghijklmnopqrstuvwxyz ")
    return [Request(request_id=f"{tag}{i}",
                    prompt="".join(rng.choice(letters, size=SPEC_PERIOD)) * 4,
                    sampling_params=SamplingParameters(max_tokens=SPEC_TOKENS,
                                                       ignore_eos=True))
            for i in range(SPEC_REQUESTS)]


def _replay_ms(graph, replays: int = 20) -> float:
    """Device ms of one replay of a captured step graph."""
    import torch
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / replays


def _near_tie(lm, tokenizer, reqs, on, off, dev, vision=None, layered=False) -> dict:
    """Where two runs' tokens of a request first differ (`on` against
    `off`): the `off` path's top-2 logit gap at that position (one prefill
    of the prompt and the `off` tokens before it, through the kernels; an
    image request's image token expanded and its features spliced in from
    the factory `vision`), against the bound of _logits_check (LOGITS_RATIO
    times the bf16 plain path's distance from f32; `layered` for a model
    whose f32 copy would not fit beside it): a divergence is a near tie
    only if its gap is within the bound."""
    import numpy as np
    import torch
    from hydrainfer_tpu_torch.models.factory import VisionModelParameters
    rows = []
    for req, a, b in zip(reqs, on, off):
        if a == b:
            continue
        pos = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
        ctx, kw = tokenizer.encode(req.prompt), {}
        with torch.no_grad():
            if req.image is not None:
                vcfg = vision.getVisionModelConfig()
                n = vcfg.image_token_calculator.get_num_image_tokens(
                    (req.image.height, req.image.width))
                i = ctx.index(vcfg.image_token_id)
                ctx = ctx[:i] + [vcfg.image_token_id] * n + ctx[i + 1:]
                pixels = np.asarray(vision.getProcessor().process(req.image))
                params = VisionModelParameters(
                    original_image_sizes=[(req.image.height, req.image.width)])
                kw = dict(image_features=vision.getVisionModel().forward(
                    pixels[None] if pixels.ndim == 3 else pixels, params).image_features[0],
                          image_dst_idx=list(range(i, i + n)))
            top2 = torch.topk(_prefill_logits(lm, ctx + b[:pos], dev, **kw)[-1], 2).values
        rows.append({"request": req.request_id, "position": pos,
                     "top2_gap": float(top2[0] - top2[1])})
    if not rows:
        return {"ok": True, "divergences": []}
    probe = [int(t) for t in np.random.default_rng(SEED).integers(10, 120, size=64)]
    check = _logits_check(lm, probe, dev, "bound", layered=layered)
    bound = LOGITS_RATIO * max(check["bound_bf16_plain_vs_f32_err"],
                               1e-3 * check["bound_f32_max_abs"])
    return {"ok": all(r["top2_gap"] <= bound for r in rows), "divergences": rows,
            "near_tie_bound": bound}


def _reference_drafts(ref: dict, prompt_len: int, vocab: int):
    """A proposer that drafts each request's continuation from a reference
    run (`ref`: prompt token ids -> that run's tokens), k tokens from where
    the request stands, the ninth made wrong: while the request follows the
    reference, a verify step accepts eight drafts and rejects the ninth
    (random weights never repeat an n-gram, so prompt lookup finds no draft
    to verify)."""
    def propose(ctx, k, n=3):
        cont = ref.get(tuple(ctx[:prompt_len]))
        if cont is None:
            return []
        done = len(ctx) - prompt_len
        draft = list(cont[done:done + k])
        if len(draft) > 8:
            draft[8] = (draft[8] + 1) % vocab
        return draft
    return staticmethod(propose)


def phase_spec(dev="cuda") -> tuple:
    """Speculative decoding on llava-7b-lm at full width (int8 weights, int8
    KV): engines of 8 (S floor 8, so a verify step is T = 128 rows, max_q
    16) on one model serve a warm-up round and a measured round of
    SPEC_REQUESTS lookup-friendly requests each, four ways: plain
    (spec_ngram_k 0), n-gram (12), drafted (12, the drafts from the plain
    run's tokens with the ninth wrong, `_reference_drafts`: random weights
    never repeat an n-gram, so the n-gram run verifies nothing) and
    redrafted (the drafts from the drafted run's tokens: a verify step's
    logits differ from a decode step's in their last bits, and the random
    model's near ties turn on them, so the drafted run leaves the plain
    tokens early; the redrafted one follows its own path's tokens). The
    drafted runs must verify, their verify key captured once (in the
    warm-up round) and replayed in the measured one, their verify steps
    launching K2, K3 and K4 (and not K1); the spec runs' tokens must be the
    plain run's, or first differ where the plain path's top-2 logit gap is a
    near tie (_near_tie). Reports tokens/s and p50 TTFT of each, tokens per
    verify step, and the verify step's device ms beside a fused window's
    per step (graph replays)."""
    import numpy as np
    import torch
    from hydrainfer_tpu_torch.engine import executor as ex
    from hydrainfer_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    dev = torch.device(dev)
    factory = _llava_factory(dev)
    lm = factory.getLanguageModel()
    tokenizer = factory.getTokenizer()
    warm_reqs = _spec_requests(np.random.default_rng(SEED + 10), "warm")
    reqs = _spec_requests(np.random.default_rng(SEED + 11), "spec")
    prompt_len = len(tokenizer.encode(reqs[0].prompt))
    tokens_of = {}      # run name -> {prompt token ids: its tokens}
    verify_launches = {}
    # the class attributes themselves (propose_ngram is a staticmethod)
    orig_spec = ex.FillExecutor.__dict__["execute_spec"]
    orig_propose = ex.FillExecutor.__dict__["propose_ngram"]

    def spy(self, batch, k_draft, ngram_n=3):
        before = launch_counts()
        fut = orig_spec(self, batch, k_draft, ngram_n)
        for k, n in launch_counts().items():
            verify_launches[k] = verify_launches.get(k, 0) + n - before[k]
        return fut

    def serve(name, k, drafts_from=None):
        if drafts_from is not None:
            ex.FillExecutor.propose_ngram = _reference_drafts(
                tokens_of[drafts_from], prompt_len, factory.cfg.vocab_size)
        free = torch.cuda.mem_get_info(dev)[0]
        engine = _engine(factory, dev, 8, 16, 256, 256, spec_ngram_k=k)
        graphs = GraphRounds(engine, free)
        fx = engine.node.fill_executor
        warm = engine.generate(warm_reqs, timeout_s=600)
        steps0, tokens0 = fx.spec_steps, fx.spec_tokens
        verify_launches.clear()
        reset_launch_counts()
        graphs.start_measured()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = engine.generate(reqs, timeout_s=600)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        graphs.end_measured()
        tokens_of[name] = {tuple(tokenizer.encode(r.prompt)): o.output_token_ids
                           for r, o in zip(warm_reqs + reqs, warm + outs)}
        ttfts = sorted(o.ttft for o in outs)
        run = {"spec_ngram_k": k, "tokens": [o.output_token_ids for o in outs],
               "tokens_per_s": sum(len(o.output_token_ids) for o in outs) / elapsed,
               "elapsed_s": elapsed, "p50_ttft_s": ttfts[len(ttfts) // 2],
               "spec_steps": fx.spec_steps - steps0, "spec_tokens": fx.spec_tokens - tokens0,
               "spec_steps_in_warmup_round": steps0, "graphs_ok": graphs.ok(),
               "graphs": graphs.report(), "verify_launches": dict(verify_launches)}
        verify = [(d, g) for (d, n), g in fx.graphs.graphs.items() if d.spec > 0]
        run["verify_keys"] = [f"T={d.T} S={d.S} MB={d.MB} max_q={d.max_q} K1={d.spec}"
                              for d, _ in verify]
        run["verify_replays"] = sum(g.replays for _, g in verify)
        run["verify_keys_captured"] = all(g.graph is not None for _, g in verify)
        # device ms of one verify step and of a fused window per step (graph
        # replays of the engine's own keys, after serving)
        run["verify_step_device_ms"] = {f"T={d.T}": _replay_ms(g.graph)
                                        for d, g in verify if g.graph is not None}
        run["window_device_ms_per_step"] = {
            f"K={n}": _replay_ms(g.graph) / n
            for (d, n), g in sorted(fx.graphs.graphs.items(), key=str)
            if d.spec == 0 and n > 1 and g.graph is not None}
        return run

    runs = {}
    ex.FillExecutor.execute_spec = spy
    try:
        runs["plain"] = serve("plain", 0)
        runs["ngram"] = serve("ngram", 12)
        runs["drafted"] = serve("drafted", 12, drafts_from="plain")
        runs["redrafted"] = serve("redrafted", 12, drafts_from="drafted")
    finally:
        ex.FillExecutor.execute_spec = orig_spec
        ex.FillExecutor.propose_ngram = orig_propose
    ref = runs["plain"]["tokens"]
    spec_runs = ("ngram", "drafted", "redrafted")
    ties = {name: _near_tie(lm, tokenizer, reqs, runs[name]["tokens"], ref, dev)
            for name in spec_runs}
    drafted = [runs["drafted"], runs["redrafted"]]
    d = runs["redrafted"]
    vl = d["verify_launches"]
    checks = {
        "all_finished": all(len(t) == SPEC_TOKENS for r in runs.values() for t in r["tokens"]),
        "plain_runs_no_verify": runs["plain"]["spec_steps"] == 0,
        "drafted_verifies": all(r["spec_steps"] > 0 and r["spec_tokens"] > r["spec_steps"]
                                for r in drafted),
        "verify_key_captured_once_then_replayed": all(
            len(r["verify_keys"]) == 1 and r["verify_keys_captured"]
            and r["spec_steps_in_warmup_round"] > 0 and r["verify_replays"] > 0
            and r["graphs"]["keys_captured_in_measured_round"] == 0 for r in drafted),
        "graphs_ok": all(r["graphs_ok"] for r in runs.values()),
        "verify_launches_k2_k3_k4": (vl.get("paged_attention", 0) > 0
                                     and vl.get("kv_writer", 0) > 0
                                     and vl.get("quant_matmul", 0) > 0
                                     and vl.get("mha_decode", 0) == 0),
        "tokens_equal_or_near_tie": all(t.pop("ok") for t in ties.values())}
    save("spec_tokens.json", {name: r.pop("tokens") for name, r in runs.items()})
    return {"phase": "spec", "ok": all(checks.values()), "checks": checks,
            "gpu": gpu_name_and_limit(), "arch": "llava-7b-lm", "weights": "int8",
            "kv_cache": "int8 (scale 0.05)", "n_requests": SPEC_REQUESTS,
            "prompt": f"{SPEC_PERIOD} seeded tokens x 4", "max_tokens": SPEC_TOKENS,
            "tokens_identical": {name: not t["divergences"] for name, t in ties.items()},
            "divergences": ties,
            # summed over the step's requests, as the node's perf line reads it
            "tokens_per_verify_step": {name: runs[name]["spec_tokens"]
                                       / max(runs[name]["spec_steps"], 1)
                                       for name in spec_runs},
            **runs,
            "tokens_per_s_ratio": {name: runs[name]["tokens_per_s"]
                                   / runs["plain"]["tokens_per_s"]
                                   for name in spec_runs}}, {
        "paged_attention": vl.get("paged_attention", 0),
        "quant_matmul": vl.get("quant_matmul", 0), "kv_writer": vl.get("kv_writer", 0)}


def _sampling_tv_checks(dev) -> dict:
    """The sampling chain's draws on the card, N = 4000 rows in one call,
    V = 16: process_logits at temperature 0.7, top-k 8, top-p 0.9 against
    the softmax of the same filters' logits (on the CPU), and the first
    token of a rejection-sampled verify (one-hot draft 3) against
    softmax(logits / 0.7): total-variation distance below 0.05 each."""
    import torch
    from hydrainfer_tpu_torch.ops import sampling
    N, V = 4000, 16
    gen = torch.Generator(device=dev).manual_seed(SEED)
    row = torch.randn(V, generator=torch.Generator().manual_seed(4))
    filt = sampling.apply_top_p(sampling.apply_top_k(
        sampling.apply_temperature(row[None], torch.tensor([0.7])),
        torch.tensor([8])), torch.tensor([0.9]))
    target = torch.softmax(filt[0], -1)
    ones = torch.ones(N, device=dev)
    toks = sampling.process_logits(
        row.to(dev).repeat(N, 1), temperature=0.7 * ones,
        top_k=torch.full((N,), 8, dtype=torch.int32, device=dev), top_p=0.9 * ones,
        generator=gen)
    tv = lambda t, p: 0.5 * float((torch.bincount(t.long().cpu(), minlength=V) / N
                                   - p).abs().sum())
    logits = torch.randn((1, 2, V), generator=torch.Generator().manual_seed(0))
    emitted, acc = sampling.spec_verify_tokens(
        logits.to(dev).repeat(N, 1, 1),
        torch.tensor([[3, 0]], dtype=torch.int32, device=dev).repeat(N, 1),
        torch.ones(N, dtype=torch.int32, device=dev), temperature=0.7 * ones,
        top_k=torch.full((N,), -1, dtype=torch.int32, device=dev), top_p=ones,
        generator=gen)
    tv_chain = tv(toks, target)
    tv_spec = tv(emitted[:, 0], torch.softmax(logits[0, 0] / 0.7, -1))
    return {"ok": tv_chain < 0.05 and tv_spec < 0.05, "tv_process_logits": tv_chain,
            "tv_spec_verify_first_token": tv_spec, "spec_verify_accepted": int(acc.sum())}


def _replay_fresh_check(dev) -> dict:
    """A sampling graph (process_logits over a flat (64, 32000) distribution
    at temperature 1) with its generator registered: two replays on the same
    inputs must draw different tokens; after reseeding the generator, two
    more replays repeat them."""
    import torch
    from hydrainfer_tpu_torch.ops import sampling
    gen = torch.Generator(device=dev).manual_seed(SEED)
    logits = torch.zeros((64, 32000), device=dev)
    temps = torch.ones(64, device=dev)
    fn = lambda: sampling.process_logits(logits, temperature=temps, generator=gen)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    graph.register_generator_state(gen)
    with torch.cuda.graph(graph):
        out = fn()
    draws = []
    for _ in range(2):
        gen.manual_seed(SEED + 1)
        for _ in range(2):
            graph.replay()
            draws.append(out.clone())
    torch.cuda.synchronize()
    fresh = not torch.equal(draws[0], draws[1])
    repeat = torch.equal(draws[0], draws[2]) and torch.equal(draws[1], draws[3])
    return {"ok": fresh and repeat, "replays_draw_fresh": fresh,
            "reseed_repeats_replays": repeat}


def phase_sample(dev="cuda") -> tuple:
    """Stochastic sampling on llava-7b-lm at full width (the spec phase's
    model): SAMPLE_REQUESTS requests at temperature 0.8, top-k 40, top-p
    0.95, SAMPLE_TOKENS tokens, through K = 16 graphed windows, after a
    sampled warm-up round (which captures the sampled keys: the measured
    round captures none and replays them), and a greedy round of the same
    shape, timed beside it. Then greedy, top-k 1 at 0.8
    (must equal greedy) and a mixed batch (greedy rows unchanged) on the same
    prompts; a profiled sampled round (the sort kernels' device ms per step);
    the chain alone at (8, 32064) from a CUDA graph; the TV checks and the
    replay check on the card."""
    import numpy as np
    import torch
    from hydrainfer_tpu_torch.engine import executor as ex
    from hydrainfer_tpu_torch.ops import sampling
    from hydrainfer_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from hydrainfer_tpu_torch.request import Request, SamplingParameters
    dev = torch.device(dev)
    factory = _llava_factory(dev)
    free = torch.cuda.mem_get_info(dev)[0]
    engine = _engine(factory, dev, SAMPLE_REQUESTS, 16, 256, 256)
    graphs = GraphRounds(engine, free)
    rng = np.random.default_rng(SEED + 20)
    letters = list("abcdefghijklmnopqrstuvwxyz ")

    def round_(tag, prompts, controls):
        reqs = [Request(request_id=f"{tag}{i}", prompt=p,
                        sampling_params=SamplingParameters(max_tokens=SAMPLE_TOKENS,
                                                           ignore_eos=True, **c))
                for i, (p, c) in enumerate(zip(prompts, controls))]
        return reqs, [o.output_token_ids for o in engine.generate(reqs, timeout_s=600)]

    new_prompts = lambda: ["".join(rng.choice(letters, size=64))
                           for _ in range(SAMPLE_REQUESTS)]
    sampled = [SAMPLE_CONTROLS] * SAMPLE_REQUESTS
    windows = []
    orig = ex.FillExecutor._multi_step_window

    def spy(self, batch, n_steps):
        n, ks = orig(self, batch, n_steps)
        windows.append(n)
        return n, ks

    ex.FillExecutor._multi_step_window = spy
    try:
        round_("warm", new_prompts(), sampled)
        windows.clear()
        reset_launch_counts()
        graphs.start_measured()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, toks = round_("sample", new_prompts(), sampled)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        graphs.end_measured()
        counts = launch_counts()
        measured_windows = list(windows)
        # a greedy round of the same shape, for the sampling chain's cost
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        round_("greedy_timed", new_prompts(), [{}] * SAMPLE_REQUESTS)
        torch.cuda.synchronize()
        greedy_elapsed = time.perf_counter() - t0
    finally:
        ex.FillExecutor._multi_step_window = orig
    sampled_keys = [(d, n, g) for (d, n), g in engine.node.fill_executor.graphs.graphs.items()
                    if d.sampling and g.graph is not None]
    # the comparison rounds share one prompt set; a first greedy round puts
    # its blocks in the prefix cache, so that the three rounds after it
    # prefill the same uncached tails at the same shapes
    prompts = new_prompts()
    greedy = [{}] * SAMPLE_REQUESTS
    round_("prime", prompts, greedy)
    _, g_toks = round_("greedy", prompts, greedy)
    _, k1_toks = round_("topk1", prompts, [dict(temperature=0.8, top_k=1)] * SAMPLE_REQUESTS)
    half = SAMPLE_REQUESTS // 2
    _, mixed = round_("mixed", prompts, greedy[:half] + sampled[half:])
    rows = []
    prof_reqs = [Request(request_id=f"prof{i}", prompt=p,
                         sampling_params=SamplingParameters(max_tokens=SAMPLE_TOKENS,
                                                            ignore_eos=True,
                                                            **SAMPLE_CONTROLS))
                 for i, p in enumerate(new_prompts())]
    profiled = _profile_round(engine, prof_reqs, "sample_profile.json", rows)
    sort_ms = sum(r["ms"] for r in rows if "sort" in r["kernel"].lower())
    vocab = factory.cfg.vocab_size
    logits = torch.randn((SAMPLE_REQUESTS, vocab), device=dev) * 3
    n = SAMPLE_REQUESTS
    gen = torch.Generator(device=dev).manual_seed(SEED)
    chain = lambda: sampling.process_logits(
        logits, temperature=torch.full((n,), 0.8, device=dev),
        top_k=torch.full((n,), 40, dtype=torch.int32, device=dev),
        top_p=torch.full((n,), 0.95, device=dev), generator=gen)
    chain_graph_ms = graph_ms(chain, generator=gen)
    # one sampled window graph of the engine replayed twice on the same inputs
    # (after serving: its state writes land in freed slots)
    window = max(sampled_keys, key=lambda x: x[1])[2]
    window.graph.replay()
    first = window.tokens.clone()
    window.graph.replay()
    engine_key_fresh = not torch.equal(first, window.tokens)
    tv = _sampling_tv_checks(dev)
    fresh = _replay_fresh_check(dev)
    tv_ok, fresh_ok = tv.pop("ok"), fresh.pop("ok")
    checks = {
        "all_finished": all(len(t) == SAMPLE_TOKENS for t in toks)
        and all(0 <= t < vocab for r in toks for t in r),
        "k16_windows": 16 in measured_windows,
        "sampled_keys_captured": len(sampled_keys) > 0,
        "graphs_ok": graphs.ok(),
        "kernels_launched": all(counts[k] > 0 for k in ("mha_decode", "kv_writer",
                                                        "quant_matmul")),
        "top_k_1_equals_greedy": k1_toks == g_toks,
        "mixed_batch_greedy_rows_unchanged": mixed[:half] == g_toks[:half],
        "tv": tv_ok, "replays_draw_fresh": fresh_ok}
    return {"phase": "sample", "ok": all(checks.values()), "checks": checks,
            "gpu": gpu_name_and_limit(), "arch": "llava-7b-lm", "weights": "int8",
            "kv_cache": "int8 (scale 0.05)", "n_requests": SAMPLE_REQUESTS,
            "max_tokens": SAMPLE_TOKENS, "controls": SAMPLE_CONTROLS,
            "tokens_per_s": sum(len(t) for t in toks) / elapsed, "elapsed_s": elapsed,
            "greedy_tokens_per_s": SAMPLE_REQUESTS * SAMPLE_TOKENS / greedy_elapsed,
            "fused_windows": sorted(set(measured_windows)), "launches": counts,
            "sampled_keys": [f"T={d.T} S={d.S} MB={d.MB} n_steps={n}"
                             for d, n, _ in sampled_keys],
            "graphs": graphs.report(), "engine_key_replays_differ": engine_key_fresh,
            "sampling_chain_graph_ms": chain_graph_ms,
            "sampling_chain_shape": f"({n}, {vocab}) f32, temperature, top-k 40, top-p 0.95",
            "profile_sort_ms_per_step": sort_ms / SAMPLE_TOKENS,
            "profile_sort_kernels": [r for r in rows if "sort" in r["kernel"].lower()][:6],
            **{k: v for k, v in profiled.items() if k != "profile_top_kernels"},
            **tv, **fresh}, counts


# ---------------------------------------------------------------- phase: vlm

def _qwen2vl_factory(dev, seed=SEED):
    """Qwen2-VL-2B at full width with random weights from a seeded generator:
    the port's Qwen2VLVisionModel (bf16) and its qwen2-vl-2b-lm language model
    (int8 weights, int8 KV at scale 0.05, M-RoPE sections [16, 24, 24]), with
    SimpleTokenizer (one token per character, "<image>" = token 9)."""
    from dataclasses import replace
    import torch
    from hydrainfer_tpu_torch.models.factory import VisionModelConfig
    from hydrainfer_tpu_torch.models.qwen2_vl import (Qwen2VisionConfig,
                                                      Qwen2VLImageProcessorAdapter,
                                                      Qwen2VLImageTokenCalculator,
                                                      Qwen2VLVisionModel)
    from hydrainfer_tpu_torch.models.random_init import RandomWeightFactory

    vcfg = Qwen2VisionConfig(**VLM_VISION)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    init = lambda *shape: (torch.randn(shape, generator=gen, device=dev) * 0.02).to(
        torch.bfloat16)
    ones = lambda n: torch.ones(n, dtype=torch.bfloat16, device=dev)
    zeros = lambda n: torch.zeros(n, dtype=torch.bfloat16, device=dev)
    E, M = vcfg.embed_dim, int(vcfg.embed_dim * vcfg.mlp_ratio)
    vw = {"patch_embed": init(vcfg.patch_dim, E), "blocks": [
        {"ln1": (ones(E), zeros(E)), "qkv": (init(E, 3 * E), zeros(3 * E)),
         "proj": (init(E, E), zeros(E)), "ln2": (ones(E), zeros(E)),
         "fc1": (init(E, M), zeros(M)), "fc2": (init(M, E), zeros(E))}
        for _ in range(vcfg.depth)]}
    vw["merger"] = {"ln_q": (ones(E), zeros(E)), "mlp0": (init(4 * E, 4 * E), zeros(4 * E)),
                    "mlp2": (init(4 * E, vcfg.hidden_size), zeros(vcfg.hidden_size))}
    lm_factory = RandomWeightFactory(VLM_ARCH, dtype=torch.bfloat16, quantization="int8",
                                     kv_scale=0.05, device=dev, seed=seed)
    lm_factory.cfg = replace(lm_factory.cfg, mrope_section=VLM_MROPE)
    return _mm_factory(lm_factory, Qwen2VLVisionModel(vw, vcfg),
                       VisionModelConfig("<image>", 9, Qwen2VLImageTokenCalculator(
                           vcfg.patch_size, vcfg.spatial_merge_size)),
                       Qwen2VLImageProcessorAdapter(vcfg))


def _mm_factory(lm_factory, vision_model, vision_config, processor):
    """A multimodal ModelFactory over a RandomWeightFactory's language model
    (`lm_factory`, whose cfg may be replaced), a built tower, its config and
    processor, with SimpleTokenizer ("<image>" = token 9)."""
    from hydrainfer_tpu_torch.models.factory import ModelFactory
    from hydrainfer_tpu_torch.models.tokenizer import SimpleTokenizer

    class Factory(ModelFactory):
        def __init__(self):
            self.vision_model = vision_model
            self.lm_factory = lm_factory
            self.cfg = lm_factory.cfg

        def getVisionModel(self):
            return self.vision_model

        def getLanguageModel(self):
            return lm_factory.getLanguageModel()

        def getVisionModelConfig(self):
            return vision_config

        def getLanguageModelConfig(self):
            return lm_factory.getLanguageModelConfig()

        def getProcessor(self):
            return processor

        def getTokenizer(self):
            return SimpleTokenizer()

    return Factory()


def _vlm_requests(rng, max_tokens, tag):
    """One request per VLM_IMAGES entry: random pixels, a 64-character prompt
    around <image> (text on both sides), greedy, ignore_eos."""
    import numpy as np
    from PIL import Image
    from hydrainfer_tpu_torch.request import Request, SamplingParameters
    letters = list("abcdefghijklmnopqrstuvwxyz ")
    reqs = []
    for i, (h, w) in enumerate(VLM_IMAGES):
        img = Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
        text = "".join(rng.choice(letters, size=64))
        reqs.append(Request(request_id=f"{tag}{i}", prompt=text[:24] + "<image>" + text[24:],
                            image=img, sampling_params=SamplingParameters(
                                max_tokens=max_tokens, ignore_eos=True)))
    return reqs


def _features_check(vm, vm32, pixel_values, params, depth: int) -> dict:
    """One encode: the bf16 tower `vm` through K5 and through the plain
    attention, each against an f32 run of the same weights (`vm32`) through
    the plain attention; and the f32 tower through K5 against that f32
    reference."""
    import torch
    from hydrainfer_tpu_torch.ops import attention
    from hydrainfer_tpu_torch.ops.cuda.mha_varlen import mha_varlen_plain
    kernel = attention.mha_varlen_flash

    def plain(q, k, v, ids, sm, **kw):
        return mha_varlen_plain(q, k, v, ids, sm, **kw)[0]

    def run(model, use_plain):
        attention.mha_varlen_flash = plain if use_plain else kernel
        try:
            return model.forward(pixel_values, params).image_features.float()
        finally:
            attention.mha_varlen_flash = kernel

    with torch.no_grad():
        ref32 = run(vm32, True)
        got32 = run(vm32, False)
        got16 = run(vm, False)
        plain16 = run(vm, True)
    scale = ref32.abs().max().item()
    err32 = (got32 - ref32).abs().max().item()
    err16_kernel = (got16 - ref32).abs().max().item()
    err16_plain = (plain16 - ref32).abs().max().item()
    ok = (bool(torch.isfinite(got16).all()) and err32 <= 1e-3 * scale
          and err16_kernel <= 3 * max(err16_plain, 1e-3 * scale))
    return {"features_ok": ok, "features_shape": list(got16.shape[1:]),
            "features_f32_max_abs": scale, "features_f32_kernel_vs_plain_err": err32,
            "features_bf16_kernel_vs_f32_err": err16_kernel,
            "features_bf16_plain_vs_f32_err": err16_plain,
            "features_tolerance": f"f32: 1e-3 x max|feature| (sum order over {depth} "
                                  "layers); bf16: 3x the plain path's distance from f32"}


def _qwen2vl_features_check(factory, reqs) -> dict:
    """_features_check on one encode of the measured round's eight images."""
    import numpy as np
    from hydrainfer_tpu_torch.models.factory import VisionModelParameters
    from hydrainfer_tpu_torch.models.qwen2_vl import Qwen2VLVisionModel
    proc = factory.getProcessor()
    patches = np.concatenate([proc.process(r.image) for r in reqs])
    params = VisionModelParameters(original_image_sizes=[(r.image.height, r.image.width)
                                                         for r in reqs])
    vm = factory.getVisionModel()
    return _features_check(vm, Qwen2VLVisionModel(_f32_tree(vm.weights), vm.cfg), patches,
                           params, vm.cfg.depth)


def _image_prefill_check(factory, req, rng, dev, chunk=0, every=0) -> dict:
    """One image-bearing prefill of the LM at full width: 24 text tokens, the
    image's tokens (features from the bf16 tower) and 40 text tokens, with
    the request processor's M-RoPE streams where the model has them; logits
    held as the serve phase holds its prefill's (_logits_check). chunk > 0:
    the prompt goes in chunks of that many tokens (_prefill_logits), each
    chunk's logits held; every > 0: every every-th row's logits too, the
    bf16 criterion in mean |error| over them (_logits_check)."""
    from types import SimpleNamespace
    import numpy as np
    import torch
    from hydrainfer_tpu_torch.engine.request_processor import RequestProcessor
    from hydrainfer_tpu_torch.models.factory import VisionModelParameters
    size = (req.image.height, req.image.width)
    pixels = np.asarray(factory.getProcessor().process(req.image))
    with torch.no_grad():
        feats = factory.getVisionModel().forward(
            pixels[None] if pixels.ndim == 3 else pixels,
            VisionModelParameters(original_image_sizes=[size])).image_features[0]
    vcfg = factory.getVisionModelConfig()
    image_id, calc = vcfg.image_token_id, vcfg.image_token_calculator
    text = [int(t) for t in rng.integers(10, 120, size=64)]
    tokens = text[:24] + [image_id] * calc.get_num_image_tokens(size) + text[24:]
    kw = {}
    if factory.getLanguageModelConfig().mrope_section:
        pt, ph, pw, _ = RequestProcessor._mrope_positions(
            SimpleNamespace(image_token_id=image_id, image_token_calculator=calc), tokens,
            [size])
        kw = dict(positions=pt, positions_hw=[ph, pw])
    if chunk:
        kw["chunk"] = chunk
    if every:
        kw.update(every=every, mean_rows=True)
    res = _logits_check(factory.getLanguageModel(), tokens, dev, "image_prefill_logits",
                        image_features=feats,
                        image_dst_idx=[i for i, t in enumerate(tokens) if t == image_id],
                        **kw)
    res["image_prefill_logits_chunks"] = -(-len(tokens) // chunk) if chunk else 1
    res["image_prefill_logits_rows_every"] = every
    return res


def _image_rounds(engine, graphs, make_requests, profile_name) -> tuple:
    """An image phase's rounds on `engine`: a warm-up round, the measured
    round and a profiled round, each of make_requests(tag). Returns the
    measured requests, their outputs and the round's record: seconds,
    launch counts (K3 split by step), peak memory, fused windows, each
    encode's images and wall time (the card synchronised around it), the
    LM steps run (fill steps count their n_steps, verify steps one: each
    step runs the lm_head once) and each image request's prefill steps (the
    fill steps that carried a chunk of its image-bearing prompt)."""
    from collections import Counter
    import torch
    from hydrainfer_tpu_torch.engine import executor as ex
    from hydrainfer_tpu_torch.engine.isa import ImageEmbedFill
    from hydrainfer_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    windows, encodes, prefills, steps = [], [], Counter(), [0]
    orig_window, orig_embed = ex.FillExecutor._multi_step_window, ex.ImageEmbedExecutor.execute
    orig_execute, orig_spec = ex.FillExecutor.execute, ex.FillExecutor.execute_spec

    def spy_window(self, batch, n_steps):
        k, ks = orig_window(self, batch, n_steps)
        windows.append(k)
        return k, ks

    def spy_execute(self, batch, n_steps=1):
        steps[0] += n_steps
        for rcb, inst in batch:
            if isinstance(inst, ImageEmbedFill):
                prefills[rcb.request_id] += 1
        return orig_execute(self, batch, n_steps)

    def spy_spec(self, *args, **kw):
        steps[0] += 1
        return orig_spec(self, *args, **kw)

    def spy_embed(self, batch):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fut = orig_embed(self, batch)
        torch.cuda.synchronize()
        encodes.append({"images": len(batch), "s": time.perf_counter() - t})
        return fut

    ex.FillExecutor._multi_step_window = spy_window
    ex.ImageEmbedExecutor.execute = spy_embed
    ex.FillExecutor.execute, ex.FillExecutor.execute_spec = spy_execute, spy_spec
    k3 = KvWriteSplit()
    try:
        engine.generate(make_requests("warm"), timeout_s=600)
        windows.clear()
        encodes.clear()
        prefills.clear()
        steps[0] = 0
        reqs = make_requests("measured")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        k3.reset(graphs.graphs)
        graphs.start_measured()
        t1 = time.perf_counter()
        outs = engine.generate(reqs, timeout_s=600)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t1
        graphs.end_measured()
        rec = {"elapsed": elapsed, "counts": {**launch_counts(), **k3.counts()},
               "k3_split": k3.report(), "peak": torch.cuda.max_memory_allocated(),
               "windows": list(windows), "encodes": list(encodes),
               "prefill_steps": dict(prefills), "lm_steps": steps[0]}
        rec["profiled"] = _profile_round(engine, make_requests("prof"), profile_name)
    finally:
        ex.FillExecutor._multi_step_window = orig_window
        ex.ImageEmbedExecutor.execute = orig_embed
        ex.FillExecutor.execute, ex.FillExecutor.execute_spec = orig_execute, orig_spec
        k3.restore()
    return reqs, outs, rec


def _round_report(outs, rec, max_tokens, vocab, graphs) -> dict:
    """The fields a serving round reports, and whether its requests all
    finished with their token counts (tokens_ok)."""
    n_tokens = [len(o.output_token_ids) for o in outs]
    ttfts = sorted(o.ttft for o in outs)
    return {"tokens_ok": all(k == max_tokens for k in n_tokens) and all(
                0 <= t < vocab for o in outs for t in o.output_token_ids),
            "tokens_per_request": n_tokens, "tokens_per_s": sum(n_tokens) / rec["elapsed"],
            "elapsed_s": rec["elapsed"], "p50_ttft_s": ttfts[len(ttfts) // 2],
            "ttfts_s": ttfts, "encodes": rec["encodes"],
            "fused_windows": sorted(set(rec["windows"])),
            "n_k16_windows": rec["windows"].count(16), "launches": rec["counts"],
            "kv_writer_launches": rec["k3_split"], "graphs": graphs.report(),
            "peak_memory_bytes": rec["peak"], **rec["profiled"]}


def phase_vlm(dev="cuda", max_tokens=32) -> tuple:
    import numpy as np
    import torch
    dev = torch.device(dev)
    t0 = time.perf_counter()
    factory = _qwen2vl_factory(dev)
    factory.getLanguageModel()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n = len(VLM_IMAGES)
    free = torch.cuda.mem_get_info(dev)[0]
    t0 = time.perf_counter()
    engine = _engine(factory, dev, n, 16, 512, 2048, node_type="EPD", n_image_blocks=64)
    boot_s = time.perf_counter() - t0
    graphs = GraphRounds(engine, free)
    rng = np.random.default_rng(SEED + 2)
    reqs, outs, rec = _image_rounds(
        engine, graphs, lambda tag: _vlm_requests(rng, max_tokens, "vlm" if tag == "measured"
                                                  else tag), "vlm_profile.json")
    report = _round_report(outs, rec, max_tokens, factory.cfg.vocab_size, graphs)
    features = _qwen2vl_features_check(factory, reqs)
    logits = _image_prefill_check(factory, reqs[1], rng, dev)
    calc = factory.getVisionModelConfig().image_token_calculator
    image_tokens = [calc.get_num_image_tokens(s) for s in VLM_IMAGES]
    counts = rec["counts"]
    ok = (report.pop("tokens_ok") and features["features_ok"] and logits.pop("ok")
          and graphs.ok() and 16 in rec["windows"]
          and all(counts[k] > 0 for k in VLM_KERNELS))
    result = {"phase": "vlm", "ok": bool(ok), "gpu": gpu_name_and_limit(),
              "model": "Qwen2-VL-2B: ViT {depth} x {embed_dim}, {num_heads} heads; LM ".format(
                  **VLM_VISION) + VLM_ARCH,
              "vision": "bf16", "weights": "int8", "kv_cache": "int8 (scale 0.05)",
              "n_requests": n, "images": VLM_IMAGES, "image_tokens": image_tokens,
              "prompt_text_chars": 64, "max_tokens": max_tokens, "token_budget": 2048,
              "weight_init_s": init_s, "boot_s": boot_s,
              "lm_param_bytes": factory.lm_factory.param_bytes(), **report, **features,
              **logits}
    return result, counts


# -------------------------------------------------------------- phase: llava

def _llava_factory_mm(dev):
    """random:llava-7b-lm+mm through getModelFactory, as a server builds it
    from its config: bf16, int8 weights, int8 KV at 0.05."""
    from hydrainfer_tpu_torch.models.factory import ModelFactoryConfig, getModelFactory
    return getModelFactory(ModelFactoryConfig(name=LLAVA_MODEL, dtype="bf16",
                                              quantization="int8", kv_cache_dtype="int8",
                                              kv_scale=0.05), dev)


def _llava_requests(rng, n, max_tokens, tag):
    """n requests of one seeded 336 x 336 image inside LLAVA_TEXT text
    characters, greedy, ignore_eos."""
    import numpy as np
    from PIL import Image
    from hydrainfer_tpu_torch.request import Request, SamplingParameters
    letters = list("abcdefghijklmnopqrstuvwxyz ")
    reqs = []
    for i in range(n):
        img = Image.fromarray(rng.integers(0, 256, (336, 336, 3), dtype=np.uint8))
        text = "".join(rng.choice(letters, size=LLAVA_TEXT))
        half = LLAVA_TEXT // 2
        reqs.append(Request(request_id=f"{tag}{i}", prompt=text[:half] + "<image>" + text[half:],
                            image=img, sampling_params=SamplingParameters(
                                max_tokens=max_tokens, ignore_eos=True)))
    return reqs


def _encode_profile(vm, pixels, params) -> dict:
    """One whole-tower encode under torch.profiler: its wall time (the card
    synchronised around it) beside the device time of its kernels, which
    says whether the host's dispatch or the card sets the encode's pace."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with torch.no_grad():
        vm.forward(pixels, params)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            vm.forward(pixels, params)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    rows = [(e.key, e.count, (getattr(e, "self_device_time_total", 0) or 0) / 1e3)
            for e in prof.key_averages() if "CUDA" in str(getattr(e, "device_type", ""))]
    rows = sorted((r for r in rows if r[2] > 0), key=lambda r: -r[2])
    return {"encode_profile_wall_ms": 1e3 * wall,
            "encode_profile_device_ms": sum(r[2] for r in rows),
            "encode_profile_kernel_launches": sum(r[1] for r in rows),
            "encode_profile_top_kernels": [{"kernel": k[:100], "count": n, "ms": ms}
                                           for k, n, ms in rows[:6]]}


def _segments_check(vm, pixels) -> dict:
    """The layer-chunked encode computes what the whole tower does: the
    embedding, the segments of LLAVA_CHUNK_LAYERS layers and the projection
    give forward's features bit for bit; and one whole-tower encode's
    profile (_encode_profile)."""
    import torch
    from hydrainfer_tpu_torch.models.factory import VisionModelParameters
    params = VisionModelParameters()
    with torch.no_grad():
        whole = vm.forward(pixels, params).image_features
        h = vm.forward_embed(pixels)
        for seg in range(vm.encode_segments(LLAVA_CHUNK_LAYERS)):
            h = vm.forward_segment(h, seg, LLAVA_CHUNK_LAYERS)
        chunked = vm.forward_project(h)
    return {"segments_identical_to_forward": bool(torch.equal(whole, chunked)),
            "encode_profile_images": len(pixels), **_encode_profile(vm, pixels, params)}


def _mixed_requests(seed, tag):
    """The mixed round: 4 text requests of LLAVA_MIXED_TOKENS tokens first,
    then 4 image requests of LLAVA_TOKENS."""
    import numpy as np
    rng = np.random.default_rng(seed)
    return (_requests(rng, 4, LLAVA_TEXT, LLAVA_MIXED_TOKENS, tag + "t")
            + _llava_requests(rng, 4, LLAVA_TOKENS, tag + "m"))


def _mixed_round(factory, dev, chunk_layers) -> tuple:
    """The mixed round on a fresh EPD engine with encode_chunk_layers =
    chunk_layers: a warm-up round, then the measured one. Reports tokens/s,
    p50 TTFT, the encode's device span (from its first launch reaching the
    card to its last segment's end, decode windows between segments
    included) and the stream time of its own calls (events around each
    call: its kernels, and the card's idle time while the host dispatches
    them), the windows run while it was in flight, the text requests' gaps
    between tokens while it was in flight (from the first encode dispatch
    to the last image request's first token), and the graph keys captured
    while serving. Returns (report, the measured requests, their tokens)."""
    import numpy as np
    import torch
    engine = _engine(factory, dev, LLAVA_REQUESTS, 16, 512, 2048, node_type="EPD",
                     n_image_blocks=32, encode_chunk_layers=chunk_layers)
    node, fx = engine.node, engine.node.fill_executor
    iee = node.image_embed_executor
    captures = [fx.graphs.captures]
    engine.generate(_mixed_requests(SEED + 4, "mwarm"), timeout_s=600)
    captures.append(fx.graphs.captures)
    keys0 = set(fx.graphs.graphs)
    marks, windows = [], []

    def timed(fn):
        def call(*args):
            before = torch.cuda.Event(enable_timing=True)
            after = torch.cuda.Event(enable_timing=True)
            t = time.perf_counter()
            before.record()
            out = fn(*args)
            after.record()
            marks.append((t, before, after))
            return out
        return call

    orig_execute = fx.execute

    def spy_execute(batch, n_steps=1):
        windows.append((iee.busy, n_steps))
        return orig_execute(batch, n_steps)

    spies = {"execute": iee.execute, "start_chunked": iee.start_chunked,
             "advance": iee.advance}
    for name, fn in spies.items():
        setattr(iee, name, timed(fn))
    fx.execute = spy_execute
    try:
        reqs = _mixed_requests(SEED + 5, "mixed")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = engine.generate(reqs, timeout_s=600)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
    finally:
        for name in spies:
            delattr(iee, name)
        del fx.execute
    new_keys = set(fx.graphs.graphs) - keys0
    w0 = marks[0][0]
    w1 = max(o.token_times[0] for o in outs[4:])
    gaps = [b - a for o in outs[:4] for a, b in zip(o.token_times, o.token_times[1:])
            if w0 <= b <= w1]
    n_tokens = [len(o.output_token_ids) for o in outs]
    ttfts = sorted(o.ttft for o in outs)
    busy = [n for b, n in windows if b]
    report = {
        "encode_chunk_layers": chunk_layers,
        "segments_an_encode": node.worker.vision_model.encode_segments(chunk_layers)
        if chunk_layers else 1,
        "encode_calls": len(marks), "tokens_per_request": n_tokens,
        "tokens_ok": n_tokens == [LLAVA_MIXED_TOKENS] * 4 + [LLAVA_TOKENS] * 4,
        "tokens_per_s": sum(n_tokens) / elapsed, "elapsed_s": elapsed,
        "p50_ttft_s": ttfts[len(ttfts) // 2],
        "image_p50_ttft_s": sorted(o.ttft for o in outs[4:])[2],
        "encode_span_ms": marks[0][1].elapsed_time(marks[-1][2]),
        "encode_device_ms": sum(b.elapsed_time(a) for _, b, a in marks),
        "text_gaps_in_flight": len(gaps),
        "text_gap_max_s": max(gaps) if gaps else None,
        "text_gap_p90_s": float(np.percentile(gaps, 90)) if gaps else None,
        "windows_while_encoding": sorted(set(busy)),
        "windows_otherwise": sorted(set(n for b, n in windows if not b)),
        "keys_captured_at_boot": captures[0],
        "keys_captured_in_warmup_round": captures[1] - captures[0],
        "keys_captured_in_measured_round": fx.graphs.captures - captures[1],
        "keys_new_in_measured_round": sorted(f"T={d.T} S={d.S} MB={d.MB} n_steps={n}"
                                             for d, n in new_keys)}
    report["ok"] = bool(report["tokens_ok"] and (
        not chunk_layers or (busy and max(busy) <= node.config.encode_chunk_window)))
    return report, reqs, [o.output_token_ids for o in outs]


def phase_llava(dev="cuda") -> tuple:
    """LLaVA-1.5-7B at full width from random:llava-7b-lm+mm (getModelFactory):
    the bf16 CLIP-L/14-336 tower (23 layers, hidden 1024, 16 heads x d64,
    577 rows an image, K5) and projector, llava-7b-lm with int8 weights and
    int8 KV (K1-K4), through OfflineEngine(node_type="EPD"): LLAVA_REQUESTS
    image requests, budget 2048, K=16 windows, a warm-up, measured and
    profiled round; K1-K5 must launch in the measured round, every request
    finish with its tokens, one encode's features through K5 agree with the
    plain attention's and one image-bearing prefill's logits with the plain
    versions', and its segments (_segments_check) must give the whole
    tower's features bit for bit. Then the mixed round (_mixed_round) with
    the whole-tower encode and with segments of LLAVA_CHUNK_LAYERS layers:
    every request
    must finish with its tokens, each request's tokens must be the same in
    both settings or first differ at a near tie (_near_tie: a window of 4
    runs a text decode in another step than a window of 16 does), and while
    the chunked encode is in flight no window may pass
    encode_chunk_window."""
    import numpy as np
    import torch
    from hydrainfer_tpu_torch.models.factory import VisionModelParameters
    from hydrainfer_tpu_torch.models.llava import LlavaVisionModel
    dev = torch.device(dev)
    t0 = time.perf_counter()
    factory = _llava_factory_mm(dev)
    factory.getLanguageModel()
    vm = factory.getVisionModel()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    free = torch.cuda.mem_get_info(dev)[0]
    t0 = time.perf_counter()
    engine = _engine(factory, dev, LLAVA_REQUESTS, 16, 512, 2048, node_type="EPD",
                     n_image_blocks=32)
    boot_s = time.perf_counter() - t0
    graphs = GraphRounds(engine, free)
    rng = np.random.default_rng(SEED + 3)
    reqs, outs, rec = _image_rounds(
        engine, graphs,
        lambda tag: _llava_requests(rng, LLAVA_REQUESTS, LLAVA_TOKENS,
                                    "llava" if tag == "measured" else tag),
        "llava_profile.json")
    report = _round_report(outs, rec, LLAVA_TOKENS, factory.cfg.vocab_size, graphs)
    del engine
    proc = factory.getProcessor()
    pixels = np.stack([proc.process(r.image) for r in reqs])
    features = _features_check(vm, LlavaVisionModel(_f32_tree(vm.weights), vm.clip_cfg),
                               pixels, VisionModelParameters(), vm.clip_cfg.n_layers)
    features.update(_segments_check(vm, pixels))
    logits = _image_prefill_check(factory, reqs[1], rng, dev)
    counts = rec["counts"]
    mixed, tokens = {}, {}
    for chunk in (0, LLAVA_CHUNK_LAYERS):
        mixed[f"chunk_{chunk}"], mreqs, tokens[chunk] = _mixed_round(factory, dev, chunk)
        torch.cuda.empty_cache()
    tie = _near_tie(factory.getLanguageModel(), factory.getTokenizer(), mreqs, tokens[0],
                    tokens[LLAVA_CHUNK_LAYERS], dev, vision=factory)
    mixed["tokens_identical"] = tokens[0] == tokens[LLAVA_CHUNK_LAYERS]
    mixed["divergences"] = tie
    save("llava_mixed_tokens.json", {str(k): v for k, v in tokens.items()})
    c = vm.clip_cfg
    ok = (report.pop("tokens_ok") and features["features_ok"] and logits.pop("ok")
          and features["segments_identical_to_forward"]
          and graphs.ok() and 16 in rec["windows"]
          and all(counts[k] > 0 for k in VLM_KERNELS)
          and all(m["ok"] for k, m in mixed.items() if k.startswith("chunk_"))
          and tie["ok"])
    result = {"phase": "llava", "ok": bool(ok), "gpu": gpu_name_and_limit(),
              "model": f"{LLAVA_MODEL}: CLIP {c.n_layers} layers x {c.hidden_size}, "
                       f"{c.n_heads} heads, {c.n_patches + 1} rows an image; projector "
                       f"{c.hidden_size} -> {factory.cfg.hidden_size}; LM "
                       + LLAVA_MODEL[len("random:"):-len("+mm")],
              "vision": "bf16", "weights": "int8", "kv_cache": "int8 (scale 0.05)",
              "n_requests": LLAVA_REQUESTS, "image": [336, 336],
              "image_tokens": c.n_patches, "prompt_text_chars": LLAVA_TEXT,
              "max_tokens": LLAVA_TOKENS, "token_budget": 2048,
              "k5_launches_an_encode": c.n_layers,
              "weight_init_s": init_s, "boot_s": boot_s,
              "lm_param_bytes": factory.param_bytes(), **report, **features, **logits,
              "mixed": mixed}
    _LLAVA_MM["factory"] = factory      # the disagg phase's, if it runs
    return result, counts


# ------------------------------------------------------------ phase: disagg

DISAGG_TEXT_REQUESTS, DISAGG_TEXT_PROMPT = 8, 128
# the cluster-wide overrides over the preset files: the budget search off at
# the default token budget of 2048, K = 16 windows, no speculation (random
# weights draft nothing, and a verify step would put K2 on the D node), the
# boot warm-up on
DISAGG_OVERRIDES = ("cluster.node.profiler.enabled=false",
                    "cluster.node.profiler.default_token_budget=2048",
                    "cluster.node.multi_step_decode=16", "cluster.node.spec_ngram_k=0",
                    "cluster.node.kv_block_size=16", "cluster.node.boot_warmup=true",
                    "cluster.node.request_processor.num_request_process_workers=1")
# per node type, over its config/node preset: explicit block counts (nodes
# sharing the card would otherwise size their caches from its free memory in
# turn, the first taking nearly all of it), and the decoding nodes' running
# cap at the traffic's 16 requests (d.yaml's 256 and epd.yaml's 64 would make
# the boot warm-up capture decode keys at S = 256 and 64)
DISAGG_NODE = {"E": {"n_image_blocks": 16},
               "P": {"n_kv_blocks": 1024, "n_image_blocks": 16},
               "EP": {"n_kv_blocks": 1024, "n_image_blocks": 16},
               "D": {"n_kv_blocks": 1024, "batch_scheduler": {"max_running_requests": 16}},
               "EPD": {"n_kv_blocks": 1024, "n_image_blocks": 16,
                       "batch_scheduler": {"max_running_requests": 16}}}
# the kernels each node type must launch in the measured round, and those it
# must not launch
DISAGG_LAUNCH = {"E": (("mha_varlen",), ("mha_decode", "paged_attention", "kv_writer",
                                         "quant_matmul", "paged_attention_latent")),
                 "P": (("paged_attention", "kv_writer", "quant_matmul"), ("mha_decode",)),
                 "D": (("mha_decode", "kv_writer", "quant_matmul"),
                       ("paged_attention", "mha_varlen")),
                 "EP": (("paged_attention", "kv_writer", "quant_matmul", "mha_varlen"), ()),
                 "EPD": (("mha_decode", "paged_attention", "kv_writer", "quant_matmul",
                          "mha_varlen"), ())}
_LLAVA_MM = {}


def _disagg_requests(seed, with_images=True):
    """The llava phase's image requests, then the text requests: the same
    content for every call with the same seed."""
    import numpy as np
    rng = np.random.default_rng(seed)
    reqs = (_llava_requests(rng, LLAVA_REQUESTS, LLAVA_TOKENS, "img")
            + _requests(rng, DISAGG_TEXT_REQUESTS, DISAGG_TEXT_PROMPT, LLAVA_TOKENS, "txt"))
    return [r for r in reqs if with_images or r.image is None]


def _disagg_cluster(factory, preset, types=None, overlay=None):
    """The cluster of config/cluster/<preset> (its specs of `types` only),
    through the port's load_config, with DISAGG_OVERRIDES and each spec's
    DISAGG_NODE overlay (`overlay`'s, by node type, merged over it), on the
    card, every node sharing `factory`."""
    from hydrainfer_tpu_torch.cluster.cluster import Cluster
    from hydrainfer_tpu_torch.config import deep_merge, load_config
    from hydrainfer_tpu_torch.entrypoint.entrypoint import EntryPointConfig
    here = os.path.dirname(os.path.abspath(__file__))
    cfg = load_config(EntryPointConfig, os.path.join(here, "config", "cluster", preset),
                      DISAGG_OVERRIDES)
    cfg.cluster.nodes = [s for s in cfg.cluster.nodes if types is None or s.node_type in types]
    for spec in cfg.cluster.nodes:
        spec.node = deep_merge(spec.node or {}, deep_merge(
            DISAGG_NODE[spec.node_type], (overlay or {}).get(spec.node_type, {})))
    return Cluster(cfg.cluster, model_factory=factory)


class NodeSpy:
    """One node's record of a serving round: the kernel launches of its own
    dispatches (the fill and encode calls run no await, so the launch
    counts' change across one call is that node's even with every node's
    step loop running), its decode windows, the host time of its encode
    calls, and its pulls: bytes, device time between CUDA events around
    the copy, and, for the first KV pull and the first image pull it ever
    makes, whether the blocks landed bit for bit (the source's gathered
    before the pull, before it frees them). A window dispatched while a
    pull's task is open or its copy still queued on the card counts as
    dispatched during a pull."""

    def __init__(self, node):
        self.node = node
        self.saved, self.bits = [], {}
        self.reset()
        fx, iee = node.fill_executor, node.image_embed_executor
        if fx is not None:
            self._wrap(fx, "execute", window=True)
            self._wrap(fx, "execute_spec", window=True)
        if iee is not None:
            for name in ("execute", "start_chunked", "advance"):
                self._wrap(iee, name, encode=True)
        orig_pull = node._pull_virtual_cache

        async def pull(src_node, src_vc, is_kv):
            import torch
            kind = "kv" if is_kv else "image"
            src = src_node.kv_cache_manager if is_kv else src_node.image_cache_manager
            check = kind not in self.bits
            src_blocks = src.gather_blocks(src_vc.block_table) if check else None
            before = torch.cuda.Event(enable_timing=True)
            after = torch.cuda.Event(enable_timing=True)
            before.record()
            t0 = time.perf_counter()
            vc = await orig_pull(src_node, src_vc, is_kv)
            after.record()
            self.pulls.append({"kind": kind, "bytes": len(src_vc.block_table)
                               * src.config.block_nbytes, "host_s": time.perf_counter() - t0,
                               "events": (before, after)})
            if check:
                dst = node.kv_cache_manager if is_kv else node.image_cache_manager
                self.bits[kind] = {"blocks": len(vc.block_table), "dtype": str(dst.dtype),
                                   "bit_equal": bool(torch.equal(
                                       dst.gather_blocks(vc.block_table), src_blocks))}
            return vc

        node._pull_virtual_cache = pull
        self.saved.append((node, "_pull_virtual_cache"))

    def _wrap(self, obj, name, window=False, encode=False):
        from hydrainfer_tpu_torch.ops.cuda import launch_counts
        orig = getattr(obj, name)

        def call(*args, **kw):
            if window:
                self.windows += 1
                pending = [p for p in self.pulls if not p["events"][1].query()]
                if self.node._pull_tasks or pending:
                    self.windows_in_pull += 1
            before = launch_counts()
            t0 = time.perf_counter()
            out = orig(*args, **kw)
            if encode:
                self.encode_host_ms.append(1e3 * (time.perf_counter() - t0))
            for k, n in launch_counts().items():
                self.counts[k] += n - before[k]
            return out

        setattr(obj, name, call)
        self.saved.append((obj, name))

    def reset(self):
        """A new round's record; the bit checks, made once (in the warm-up
        round: their gathers and compare synchronise the card), stay."""
        from collections import Counter
        self.counts, self.windows, self.windows_in_pull = Counter(), 0, 0
        self.pulls, self.encode_host_ms = [], []

    def restore(self):
        for obj, name in self.saved:
            delattr(obj, name)

    def pull_report(self) -> dict:
        nbytes = sum(p["bytes"] for p in self.pulls)
        dev_ms = sum(p["events"][0].elapsed_time(p["events"][1]) for p in self.pulls)
        return {"pulls": len(self.pulls), "mb": nbytes / 1e6, "device_ms": dev_ms,
                "host_s": sum(p["host_s"] for p in self.pulls),
                "copy_gb_per_s": nbytes / dev_ms / 1e6 if dev_ms else None,
                "bound_ms": 1e3 * 2 * nbytes / HBM_BYTES_PER_S,
                "windows": self.windows, "windows_during_pull": self.windows_in_pull,
                "encode_calls_host_ms": self.encode_host_ms, "first_pulls": self.bits}


async def _cluster_round(cluster, reqs, timeout_s=300):
    """Serve `reqs` through Cluster.add_request with every node's step loop
    running (Cluster.start) until each request has finished; a step loop
    that dies fails the round."""
    from hydrainfer_tpu_torch.engine.output_token_processor import (
        OfflineOutputTokenProcessor, OutputTokenParams)
    from hydrainfer_tpu_torch.engine.request_processor import RequestProcessParameters
    from hydrainfer_tpu_torch.request import OfflineInferenceOutput
    tokenizer = cluster.nodes[0].model_factory.getTokenizer()
    outs, done = [], []
    await cluster.start()
    try:
        for req in reqs:
            outs.append(OfflineInferenceOutput(arrival_time=time.perf_counter()))
            proc = OfflineOutputTokenProcessor(outs[-1], tokenizer, on_finish=done.append)
            await cluster.add_request(req, RequestProcessParameters(
                output_token_processors=[proc],
                output_token_params=OutputTokenParams(stream_output=False)))
        deadline = time.perf_counter() + timeout_s
        while len(done) < len(reqs):
            await asyncio.sleep(0.002)
            for node in cluster.nodes:
                for t in node._tasks:
                    if t.done():
                        raise RuntimeError(f"{node.name}'s loop ended: {t.exception()!r}")
            if time.perf_counter() > deadline:
                raise TimeoutError(f"{len(done)}/{len(reqs)} finished")
    finally:
        await cluster.stop()
    return outs


# the disagg phase's general topology logs the latency breakdown on every node
BREAKDOWN_OVERLAY = {t: {"log_latency_breakdown": True} for t in ("E", "P", "D")}


class BreakdownLog:
    """The breakdowns the port's nodes log (cluster/node.py's
    log_latency_breakdown, replaced while recording), each with the time it
    was logged."""

    def __init__(self):
        from hydrainfer_tpu_torch.cluster import node
        self.node, self.saved, self.logged = node, node.log_latency_breakdown, []

    def start(self) -> None:
        self.t0 = time.perf_counter()
        self.node.log_latency_breakdown = lambda m: self.logged.append(
            (m.breakdown(), time.perf_counter()))

    def restore(self) -> None:
        self.node.log_latency_breakdown = self.saved

    def report(self, reqs) -> dict:
        """Each finished request logged once; JAX's stage names (an image
        request: its encode, two pulls (E -> P the ep_transfer, P -> D the
        pd_transfer, as the JAX node names a request's first and second
        pull), prefill and decode; a text one: one pull, prefill and
        decode); every span non-negative and within the request's wall time
        (the round's start to its log)."""
        from hydrainfer_tpu_torch.engine.metric import STAGES
        n_images = sum(r.image is not None for r in reqs)
        text = {"prefill_execute", "decode_execute", "ep_transfer"}
        image = text | {"encode_execute", "pd_transfer"}
        names = [set(b) for b, _ in self.logged]
        spans_ok = all(0.0 <= dt <= at - self.t0 for b, at in self.logged for dt in b.values())
        ok = (len(self.logged) == len(reqs) and all(n <= set(STAGES) for n in names)
              and sum("encode_execute" in n for n in names) == n_images
              and all(n >= (image if "encode_execute" in n else text) for n in names)
              and spans_ok)
        stage_sets = {}
        for n in names:
            key = ",".join(st for st in STAGES if st in n)
            stage_sets[key] = stage_sets.get(key, 0) + 1
        return {"ok": bool(ok), "logged": len(self.logged), "requests": len(reqs),
                "spans_within_wall_time": bool(spans_ok), "stage_sets": stage_sets,
                "max_s": {st: max((b[st] for b, _ in self.logged if st in b), default=None)
                          for st in STAGES}}


def _disagg_topology(factory, preset, types, with_images, make_requests=None,
                     overlay=None, breakdown=False) -> tuple:
    """Boot the topology, serve a warm-up round and the measured round, and
    check it (module docstring, `disagg`). make_requests(seed): each round's
    requests (_disagg_requests by default); overlay: _disagg_cluster's;
    breakdown: check the latency breakdown the nodes log in the measured
    round (BreakdownLog; the overlay turns it on). Returns (report, the
    measured requests, their tokens)."""
    import torch
    if make_requests is None:
        make_requests = lambda seed: _disagg_requests(seed, with_images)  # noqa: E731
    t0 = time.perf_counter()
    cluster = _disagg_cluster(factory, preset, types, overlay)
    boot_s = time.perf_counter() - t0
    nodes = cluster.nodes

    def pools(n):
        return {k: m.n_available_blocks() for k, m in (("kv", n.kv_cache_manager),
                                                        ("image", n.image_cache_manager))
                if m is not None}

    free0 = {n.name: pools(n) for n in nodes}
    def keys(n):
        fx = n.fill_executor
        if fx is None or fx.graphs is None:
            return set()
        return {key for key, g in fx.graphs.graphs.items() if g.graph is not None}

    keys0 = {n.name: keys(n) for n in nodes}
    spies = [NodeSpy(n) for n in nodes]
    log = BreakdownLog() if breakdown else None
    try:
        asyncio.run(_cluster_round(cluster, make_requests(SEED + 6)))
        keys1 = {n.name: keys(n) for n in nodes}
        for s in spies:
            s.reset()
        reqs = make_requests(SEED + 7)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        if log is not None:
            log.start()
        t1 = time.perf_counter()
        outs = asyncio.run(_cluster_round(cluster, reqs))
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t1
    finally:
        for s in spies:
            s.restore()
        if log is not None:
            log.restore()
    n_tokens = [len(o.output_token_ids) for o in outs]
    tokens_ok = n_tokens == [r.sampling_params.max_tokens for r in reqs]
    image = [o.ttft for r, o in zip(reqs, outs) if r.image is not None]
    text = [o.ttft for r, o in zip(reqs, outs) if r.image is None]
    per_node, ok = {}, tokens_ok
    for n, s in zip(nodes, spies):
        must, must_not = DISAGG_LAUNCH[str(n.context.node_type)]
        fx = n.fill_executor
        free = fx._free_slots if fx is not None else []
        row = {"launches": dict(s.counts),
               "launches_ok": (all(s.counts[k] > 0 for k in must)
                               and all(s.counts[k] == 0 for k in must_not)),
               "migrating_requests": n.batch_scheduler.metrics().n_requests_waiting_migrate,
               "free_blocks_start": free0[n.name], "free_blocks_end": pools(n),
               "token_slots_ok": (len(free) == len(set(free))
                                  and all(0 <= x < fx.token_table.shape[0] - 1 for x in free)
                                  and len(free) == n.config.token_table_size)
               if fx is not None else True,
               "graph_keys_captured": {
                   rnd: sorted(f"T={d.T} S={d.S} MB={d.MB} n_steps={k}" for d, k in new)
                   for rnd, new in (("boot", keys0[n.name]),
                                    ("warmup_round", keys1[n.name] - keys0[n.name]),
                                    ("measured_round", keys(n) - keys1[n.name]))},
               "max_running_requests": n.config.batch_scheduler.max_running_requests,
               **s.pull_report(),
               **{k: v for k, v in n.metrics().items() if k.startswith("migration_")}}
        bits_ok = all(b["bit_equal"] for b in s.bits.values())
        ok = ok and (row["launches_ok"] and row["migrating_requests"] == 0
                     and row["free_blocks_start"] == row["free_blocks_end"]
                     and row["token_slots_ok"] and bits_ok)
        per_node[n.name] = row
    # a split topology must have pulled KV blocks (and, with an E node,
    # image blocks) and held the first of each bit for bit
    types = [str(n.context.node_type) for n in nodes]
    need = set() if len(nodes) == 1 else {"kv"} | ({"image"} if "E" in types else set())
    ok = ok and need <= {k for s in spies for k in s.bits}
    report = {"topology": [f"{n.name}" for n in nodes], "boot_s": boot_s,
              "tokens_ok": tokens_ok,
              "tokens_per_s": sum(n_tokens) / elapsed, "elapsed_s": elapsed,
              "image_p50_ttft_s": sorted(image)[len(image) // 2] if image else None,
              "text_p50_ttft_s": sorted(text)[len(text) // 2] if text else None,
              "peak_memory_bytes": torch.cuda.max_memory_allocated(), "nodes": per_node}
    if log is not None:
        report["latency_breakdown"] = log.report(reqs)
        ok = ok and report["latency_breakdown"]["ok"]
    report["ok"] = bool(ok)
    del cluster, spies, nodes
    return report, reqs, [o.output_token_ids for o in outs]


def phase_disagg(dev="cuda") -> dict:
    """EPD disaggregation in process on the one card: LLaVA-1.5-7B at full
    width (random:llava-7b-lm+mm, the llava phase's factory when it ran,
    one weight copy shared by every node) served by Clusters built from
    config/cluster/*.yaml through the port's load_config (DISAGG_OVERRIDES,
    DISAGG_NODE: spec_ngram_k = 0, since random weights draft nothing and a
    verify step would put K2 on the D node; the decoding nodes' running cap
    lowered from the presets' to the traffic's 16 so that their boot warm-up
    stays short; the preset files stay as they are): one EPD node (the
    reference), hybrid (EP + D), general (E + P + D), and general's P + D on
    the text requests only. Traffic: the llava phase's 8 image requests and
    8 text requests of 128 tokens, 32 tokens each, through
    Cluster.add_request with every node's step loop running, a warm-up round
    and a measured round. Checks: every request finishes with its tokens;
    each request's tokens equal the EPD node's or first differ at a near tie
    (_near_tie: the D node decodes in K1 / K4-skinny steps where the EPD
    node may run a decode row in a mixed K2 / K4-wide step); each node's own
    launches in the measured round (DISAGG_LAUNCH: E only K5; P K2-K4 and no
    K1; D K1, K3, K4 and no K2 or K5; EP K2-K5); the first migrated KV
    blocks (int8) and image blocks (bf16) equal the source's bit for bit; no
    request left migrating; every pool's free blocks back to their start;
    no duplicate or foreign token slot. Reports per topology tokens/s and
    p50 TTFT (image and text apart) beside the EPD node's, the pulls (MB,
    host seconds, device ms, copy GB/s beside 2 x bytes over the HBM rate),
    the decode windows dispatched during a pull, the graph keys captured
    while serving, and peak memory."""
    import gc
    import torch
    dev = torch.device(dev)
    t0 = time.perf_counter()
    factory = _LLAVA_MM.pop("factory", None)
    shared = factory is not None
    if factory is None:
        factory = _llava_factory_mm(dev)
    factory.getLanguageModel()
    factory.getVisionModel()
    init_s = time.perf_counter() - t0
    epd, _, epd_tokens = _disagg_topology(factory, "single.yaml", None, True)
    gc.collect()
    torch.cuda.empty_cache()
    result = {"phase": "disagg", "gpu": gpu_name_and_limit(),
              "model": LLAVA_MODEL + " (bf16 tower and projector, int8 weights, int8 KV)",
              "factory_shared_with_llava_phase": shared, "weight_init_s": init_s,
              "requests": f"{LLAVA_REQUESTS} image ({LLAVA_TEXT} characters and one 336 x "
                          f"336 image) + {DISAGG_TEXT_REQUESTS} text ({DISAGG_TEXT_PROMPT} "
                          f"tokens), {LLAVA_TOKENS} tokens each; pd_text: the text ones",
              "epd": epd}
    ok = epd["ok"]
    for name, preset, types, with_images in (("hybrid", "hybrid.yaml", None, True),
                                             ("general", "general.yaml", None, True),
                                             ("pd_text", "general.yaml", ("P", "D"), False)):
        # general's nodes log the latency breakdown (BreakdownLog)
        logs = name == "general"
        rep, reqs, tokens = _disagg_topology(factory, preset, types, with_images,
                                             overlay=BREAKDOWN_OVERLAY if logs else None,
                                             breakdown=logs)
        ref = epd_tokens if with_images else epd_tokens[LLAVA_REQUESTS:]
        tie = _near_tie(factory.getLanguageModel(), factory.getTokenizer(), reqs, tokens, ref,
                        dev, vision=factory)
        rep["tokens_identical_to_epd"] = tokens == ref
        rep["divergences"] = tie
        rep["ok"] = bool(rep["ok"] and tie["ok"])
        ok = ok and rep["ok"]
        result[name] = rep
        gc.collect()
        torch.cuda.empty_cache()
    result["ok"] = bool(ok)
    save("disagg.json", result)
    # the process phase's reference and its in-process numbers, if it runs
    _LLAVA_MM.update(factory=factory, epd_tokens=epd_tokens, epd=epd,
                     general=result["general"])
    return result


# ----------------------------------------------------------- phase: process

# the model of every node process (each builds it from the seed), over the
# disagg phase's DISAGG_OVERRIDES and DISAGG_NODE
PROCESS_MODEL = (f"cluster.node.model.name={LLAVA_MODEL}", "cluster.node.model.dtype=bf16",
                 "cluster.node.model.quantization=int8",
                 "cluster.node.model.kv_cache_dtype=int8")
PROCESS_BOOT_LIMIT_S = 600
# the requests in flight on the D node when it is killed, and their tokens
RESPAWN_REQUESTS, RESPAWN_TOKENS = 4, 2048
# the entry point as a child: hybrid.yaml's EP + D, explicit pools, the budget
# search and the boot warm-up off (d.yaml's 256 running requests would have
# the warm-up capture decode keys at S = 256)
ENTRY_CONFIG = "config/cluster/hybrid.yaml"
ENTRY_OVERRIDES = ("cluster.deployment=process", *PROCESS_MODEL,
                   "cluster.node.n_kv_blocks=1024", "cluster.node.n_image_blocks=16",
                   "cluster.node.profiler.enabled=false", "cluster.node.spec_ngram_k=0",
                   "cluster.node.boot_warmup=false",
                   "cluster.node.request_processor.num_request_process_workers=1")
ENTRY_CHATS, ENTRY_IMAGES, ENTRY_TOKENS = 16, 8, 32
# the context time-slicing probe: bf16 GEMMs of this size a process
SLICE_N, SLICE_ITERS = 8192, 200


def _process_config(preset):
    """config/cluster/<preset> through the port's load_config with
    DISAGG_OVERRIDES, PROCESS_MODEL and each spec's DISAGG_NODE overlay, as
    a ProcessClusterConfig on the card."""
    from hydrainfer_tpu_torch.cluster.process_node import ProcessClusterConfig
    from hydrainfer_tpu_torch.config import deep_merge, load_config
    from hydrainfer_tpu_torch.entrypoint.entrypoint import EntryPointConfig
    here = os.path.dirname(os.path.abspath(__file__))
    cfg = load_config(EntryPointConfig, os.path.join(here, "config", "cluster", preset),
                      DISAGG_OVERRIDES + PROCESS_MODEL)
    for spec in cfg.cluster.nodes:
        spec.node = deep_merge(spec.node or {}, DISAGG_NODE[spec.node_type])
    return ProcessClusterConfig(nodes=cfg.cluster.nodes, node=cfg.cluster.node,
                                start_timeout_s=PROCESS_BOOT_LIMIT_S,
                                health_interval_s=1.0, health_strikes=3)


async def _process_round(cluster, reqs, tokenizer, timeout_s=300):
    """Serve `reqs` through ProcessCluster.add_request until each has
    finished (parent-side processors); a node declared dead fails it."""
    from hydrainfer_tpu_torch.engine.output_token_processor import (
        OfflineOutputTokenProcessor, OutputTokenParams)
    from hydrainfer_tpu_torch.engine.request_processor import RequestProcessParameters
    from hydrainfer_tpu_torch.request import OfflineInferenceOutput
    outs, done = [], []
    for req in reqs:
        outs.append(OfflineInferenceOutput(arrival_time=time.perf_counter()))
        proc = OfflineOutputTokenProcessor(outs[-1], tokenizer, on_finish=done.append)
        await cluster.add_request(req, RequestProcessParameters(
            output_token_processors=[proc],
            output_token_params=OutputTokenParams(stream_output=False)))
    deadline = time.perf_counter() + timeout_s
    while len(done) < len(reqs):
        await asyncio.sleep(0.005)
        dead = [h.name for h in cluster.handles if not h.alive]
        if dead:
            raise RuntimeError(f"node processes died: {dead}")
        if time.perf_counter() > deadline:
            raise TimeoutError(f"{len(done)}/{len(reqs)} finished")
    return outs


def _token_rows(blocks, n):
    """The first n token rows of a gather_blocks payload (n_blocks, layers,
    tensors, block, heads, dim), as raw bits."""
    import torch
    x = blocks.movedim(0, 2)
    x = x.reshape(*x.shape[:2], -1, *x.shape[4:])[:, :, :n].contiguous()
    return x.view(torch.int16 if x.element_size() == 2 else torch.int8)


async def _first_pulls_bit_equal(cluster, rows) -> dict:
    """For each node's latest pull of each kind (its metrics row), the
    source's and the destination's blocks read back over RPC: the pulled
    token rows must be equal bit for bit."""
    import torch
    handles = {h.name: h for h in cluster.handles}
    out = {}
    for dst_name, row in rows.items():
        for src_name, kinds in row.get("migration_last_pulls", {}).items():
            for kind, rec in kinds.items():
                is_kv = kind == "kv"
                src = await handles[src_name].client.call("gather_blocks", is_kv, rec["src"])
                dst = await handles[dst_name].client.call("gather_blocks", is_kv, rec["dst"])
                out[kind] = {"source": src_name, "destination": dst_name,
                             "blocks": len(rec["src"]), "tokens": rec["tokens"],
                             "dtype": str(dst.dtype),
                             "bit_equal": bool(torch.equal(_token_rows(src, rec["tokens"]),
                                                           _token_rows(dst, rec["tokens"])))}
    return out


async def _settled(cluster, rows0, timeout_s=30.0) -> dict:
    """The nodes' metrics once no request is left migrating and every pool
    has its boot-time available blocks back (a node frees a finished
    request's blocks after it pushed the last token, so the parent may see
    the round end first), or as they stand after `timeout_s`."""
    deadline = time.perf_counter() + timeout_s
    while True:
        rows = await cluster.metrics_async()
        if all(r.get("migrating_requests") == 0
               and all(r.get(k) == v for k, v in rows0[n].items()
                       if k.endswith("_available_blocks"))
               for n, r in rows.items()) or time.perf_counter() > deadline:
            return rows
        await asyncio.sleep(0.05)


def _delta(after: dict, before: dict, key: str):
    return after.get(key, 0) - before.get(key, 0)


def _smi(query: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-{query}", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=30)
    return out.stdout.strip()


async def _process_general(dev, tokenizer, reqs_warm, reqs, lone) -> dict:
    """E + P + D as three spawned processes (module docstring, `process`):
    boot, the lone request and the first pulls' bit check, a warm-up and a
    measured round with their launch, pull and pool checks, then the D
    node's kill and respawn."""
    import torch
    from hydrainfer_tpu_torch.cluster.process_node import ProcessCluster
    from hydrainfer_tpu_torch.engine.output_token_processor import LogOutputTokenProcessor
    from hydrainfer_tpu_torch.engine.request_processor import RequestProcessParameters
    import numpy as np
    torch.cuda.synchronize()
    parent0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    cluster = ProcessCluster(_process_config("general.yaml"))
    res, checks = {}, {}
    try:
        await cluster.wait_ready()
        res["boot_s"] = time.perf_counter() - t0          # spawn to all pinged
        await cluster.start()
        rows0 = await cluster.metrics_async()
        # the lone image request: E -> P -> D with nothing else running, so
        # the blocks it moved are read back as they landed
        lone_out = await _process_round(cluster, [lone], tokenizer)
        checks["lone_tokens"] = len(lone_out[0].output_token_ids) == LLAVA_TOKENS
        bits = await _first_pulls_bit_equal(cluster, await cluster.metrics_async())
        res["first_pulls"] = bits
        checks["first_pulls_bit_equal"] = (set(bits) == {"kv", "image"}
                                           and all(b["bit_equal"] for b in bits.values()))
        await _process_round(cluster, reqs_warm, tokenizer)
        before = await _settled(cluster, rows0)
        t1 = time.perf_counter()
        outs = await _process_round(cluster, reqs, tokenizer)
        elapsed = time.perf_counter() - t1
        after = await _settled(cluster, rows0)
        res["card_memory_used_mib"] = _smi("gpu=memory.used")
        torch.cuda.synchronize()
        checks["parent_card_memory_0"] = torch.cuda.memory_allocated() == parent0
        n_tokens = [len(o.output_token_ids) for o in outs]
        checks["tokens"] = all(n == LLAVA_TOKENS for n in n_tokens)
        image = sorted(o.ttft for r, o in zip(reqs, outs) if r.image is not None)
        text = sorted(o.ttft for r, o in zip(reqs, outs) if r.image is None)
        res.update(tokens_per_s=sum(n_tokens) / elapsed, elapsed_s=elapsed,
                   image_p50_ttft_s=image[len(image) // 2], text_p50_ttft_s=text[len(text) // 2])
        nodes, launches = {}, {}
        for h in cluster.handles:
            a, b, r0 = after[h.name], before[h.name], rows0[h.name]
            must, must_not = DISAGG_LAUNCH[str(h.node_type)]
            lc = {k: a["launches"][k] - b["launches"][k] for k in a["launches"]}
            for k, n in lc.items():
                launches[k] = launches.get(k, 0) + n
            pulls = _delta(a, b, "migration_pulls")
            ipc = _delta(a, b, "migration_ipc_pulls")
            mb = _delta(a, b, "migration_pull_mb")
            host_s = _delta(a, b, "migration_pull_s_total")
            export_s = _delta(a, b, "migration_ipc_export_s")
            copy_s = _delta(a, b, "migration_ipc_copy_s")
            row = {"pid": a["pid"], "launches": lc,
                   "launches_ok": (all(lc[k] > 0 for k in must)
                                   and all(lc[k] == 0 for k in must_not)),
                   "pulls": pulls, "ipc_pulls": ipc,
                   "shm_pulls": _delta(a, b, "migration_shm_pulls"),
                   "pull_mb": mb, "pull_host_ms_each": 1e3 * host_s / pulls if pulls else None,
                   # of which waiting for the source's export, and for the
                   # copy on this card behind the windows queued before it
                   "pull_export_ms_each": 1e3 * export_s / ipc if ipc else None,
                   "pull_copy_ms_each": 1e3 * copy_s / ipc if ipc else None,
                   "pull_gb_per_s": mb / 1e3 / host_s if host_s else None,
                   "pull_bound_ms_each": (1e3 * 2 * mb * 1e6 / HBM_BYTES_PER_S / pulls
                                          if pulls else None),
                   "migrating_requests": a["migrating_requests"],
                   "available_blocks_start": {k: r0[k] for k in r0 if k.endswith("_available_blocks")},
                   "available_blocks_end": {k: a[k] for k in a if k.endswith("_available_blocks")},
                   "peak_memory_bytes": a.get("cuda_peak_memory_allocated"),
                   "memory_allocated_bytes": a.get("cuda_memory_allocated"),
                   "alloc_conf": a.get("cuda_alloc_conf"), "graph_keys": a.get("graph_keys")}
            row["ok"] = bool(row["launches_ok"] and row["migrating_requests"] == 0
                             and row["available_blocks_start"] == row["available_blocks_end"]
                             and ipc == pulls and row["shm_pulls"] == 0)
            nodes[h.name] = row
        checks["nodes"] = all(r["ok"] for r in nodes.values())
        checks["pulls_in_both_kinds"] = (nodes["PNode:p0"]["pulls"] > 0
                                         and nodes["DNode:d0"]["pulls"] > 0)
        res["nodes"], res["launches"] = nodes, launches

        # the D node killed with requests in flight on it
        rng = np.random.default_rng(SEED + 8)
        long_reqs = _requests(rng, RESPAWN_REQUESTS, DISAGG_TEXT_PROMPT, RESPAWN_TOKENS, "kill")
        procs = [LogOutputTokenProcessor() for _ in long_reqs]
        for req, proc in zip(long_reqs, procs):
            await cluster.add_request(req, RequestProcessParameters(
                output_token_processors=[proc]))
        deadline = time.perf_counter() + 120
        while not all(len(p.token_ids) >= 2 * 16 for p in procs):
            if time.perf_counter() > deadline or any(p.finished for p in procs):
                raise RuntimeError("the long requests never decoded on the D node")
            await asyncio.sleep(0.01)
        d = next(h for h in cluster.handles if h.name == "DNode:d0")
        held = [cluster._node_by_request.get(r.request_id, (None,))[0] for r in long_reqs]
        t_kill = time.perf_counter()
        d.proc.kill()
        while not all(p.finished for p in procs):
            if time.perf_counter() - t_kill > 60:
                raise RuntimeError("the killed node's requests were not terminated")
            await asyncio.sleep(0.01)
        terminated_s = time.perf_counter() - t_kill
        while not (d.alive and d.respawns == 1):
            if time.perf_counter() - t_kill > PROCESS_BOOT_LIMIT_S:
                raise RuntimeError("the D node was not respawned")
            await asyncio.sleep(0.1)
        respawn_s = time.perf_counter() - t_kill
        again = await _process_round(cluster, _disagg_requests(SEED + 9)[LLAVA_REQUESTS - 1:
                                                                     LLAVA_REQUESTS + 1],
                                     tokenizer)
        checks["respawn"] = (all(x == "DNode:d0" for x in held)
                             and all(p.terminated and len(p.token_ids) < RESPAWN_TOKENS
                                     for p in procs)
                             and all(len(o.output_token_ids) == LLAVA_TOKENS for o in again))
        res["respawn"] = {"held_by": held, "tokens_at_kill": [len(p.token_ids) for p in procs],
                          "terminated_s": terminated_s, "respawned_s": respawn_s,
                          "after": [len(o.output_token_ids) for o in again]}
    finally:
        await cluster.stop()
    res["tokens"] = [o.output_token_ids for o in outs]
    res["checks"] = checks
    return res


def _timeslice_worker(n, iters, barrier, out):
    """One process's bf16 GEMM loop, started with the others at the barrier."""
    import torch
    a = torch.randn(n, n, device="cuda", dtype=torch.bfloat16)
    for _ in range(3):
        a @ a
    torch.cuda.synchronize()
    barrier.wait()
    t0 = time.perf_counter()
    for _ in range(iters):
        a @ a
    torch.cuda.synchronize()
    out.put(time.perf_counter() - t0)


def _timeslice() -> dict:
    """How CUDA contexts of several processes share the card: the same GEMM
    loop in one process alone, then in two at once (seconds each)."""
    import multiprocessing
    ctx = multiprocessing.get_context("spawn")
    out = {}
    for n_proc in (1, 2):
        barrier, q = ctx.Barrier(n_proc), ctx.Queue()
        procs = [ctx.Process(target=_timeslice_worker,
                             args=(SLICE_N, SLICE_ITERS, barrier, q)) for _ in range(n_proc)]
        for p in procs:
            p.start()
        secs = [q.get(timeout=300) for _ in procs]
        for p in procs:
            p.join(timeout=30)
        out[f"{n_proc}_process"] = secs
    flops = 2 * SLICE_N ** 3 * SLICE_ITERS
    alone = out["1_process"][0]
    return {"gemm": f"{SLICE_ITERS} x bf16 {SLICE_N}^3 a process", "seconds": out,
            "alone_tflops": flops / alone / 1e12,
            "two_at_once_over_two_alone": max(out["2_process"]) / (2 * alone)}


def _png_b64(rng) -> str:
    import base64
    import io
    import numpy as np
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 256, (336, 336, 3), dtype=np.uint8)).save(buf, "PNG")
    return base64.b64encode(buf.getvalue()).decode()


def _process_entrypoint() -> dict:
    """`python -m hydrainfer_tpu_torch.entrypoint.entrypoint --config
    config/cluster/hybrid.yaml cluster.deployment=process` (ENTRY_OVERRIDES)
    as a child: ENTRY_CHATS streaming chats at once, ENTRY_IMAGES of them
    with an image_url; every stream must end in [DONE] with its deltas,
    /metrics must list both nodes with every pull over CUDA IPC, SIGTERM
    must end the child with 0, and afterwards neither node process may be
    alive or on the card."""
    import signal
    import numpy as np
    root = os.path.dirname(os.path.abspath(__file__))
    port = _free_port()
    cmd = [sys.executable, "-m", "hydrainfer_tpu_torch.entrypoint.entrypoint",
           "--config", ENTRY_CONFIG, *ENTRY_OVERRIDES, f"api_server.port={port}"]
    os.makedirs(OUT_DIR, exist_ok=True)
    log_path = os.path.join(OUT_DIR, "process_server.log")
    env = dict(os.environ, HYDRAINFER_LOG_LEVEL="INFO")
    rng = np.random.default_rng(SEED + 10)
    letters = list("abcdefghijklmnopqrstuvwxyz ")
    res, checks = {"command": cmd, "server_log": log_path}, {}
    with open(log_path, "w") as log:
        t0 = time.perf_counter()
        child = subprocess.Popen(cmd, cwd=root, env=env, stdout=log, stderr=subprocess.STDOUT)
        try:
            while True:
                if child.poll() is not None:
                    raise RuntimeError(f"the entry point exited with {child.returncode} "
                                       f"while booting (log: {log_path})")
                if time.perf_counter() - t0 > PROCESS_BOOT_LIMIT_S:
                    raise RuntimeError("the entry point did not boot in time")
                try:
                    if _http(port, "GET", "/health", timeout=5)[0] == 200:
                        break
                except OSError:
                    pass
                time.sleep(0.5)
            res["boot_s"] = time.perf_counter() - t0
            chats = [("".join(rng.choice(letters, size=64)),
                      _png_b64(rng) if i < ENTRY_IMAGES else None) for i in range(ENTRY_CHATS)]
            from concurrent.futures import ThreadPoolExecutor
            t1 = time.perf_counter()
            with ThreadPoolExecutor(ENTRY_CHATS) as pool:
                streams = list(pool.map(lambda c: _stream_chat(port, c[0], ENTRY_TOKENS,
                                                               image_b64=c[1]), chats))
            burst_s = time.perf_counter() - t1
            status, body = _http(port, "GET", "/metrics", timeout=60)
            rows = json.loads(body) if status == 200 else {}
            n_deltas = [len(st["times"]) for st in streams]
            checks["streams_done"] = all(st["status"] == 200 and st["done"] for st in streams)
            checks["deltas"] = all(n == ENTRY_TOKENS for n in n_deltas)
            checks["metrics_nodes"] = sorted(rows) == ["DNode:d0", "EPNode:ep0"]
            d_row = rows.get("DNode:d0", {})
            checks["ipc_pulls"] = (d_row.get("migration_pulls", 0) >= ENTRY_CHATS
                                   and d_row.get("migration_ipc_pulls") == d_row["migration_pulls"])
            first = lambda sel: sorted(st["times"][0] for st, c in zip(streams, chats)
                                       if st["times"] and sel(c))
            img_first, txt_first = first(lambda c: c[1]), first(lambda c: not c[1])
            res.update(burst_s=burst_s, tokens_per_s=sum(n_deltas) / burst_s,
                       image_p50_first_delta_s=img_first[len(img_first) // 2],
                       text_p50_first_delta_s=txt_first[len(txt_first) // 2],
                       nodes={k: {f: v.get(f) for f in ("pid", "migration_pulls",
                                                         "migration_ipc_pulls",
                                                         "migration_pull_mb",
                                                         "cuda_peak_memory_allocated")}
                              for k, v in rows.items()})
            pids = [v.get("pid") for v in rows.values()]
            child.send_signal(signal.SIGTERM)
            rc = child.wait(timeout=ONLINE_STOP_LIMIT_S)
            checks["sigterm_exit_0"] = rc == 0
        finally:
            if child.poll() is None:
                child.kill()
                child.wait()

    def gone(pid):
        try:
            with open(f"/proc/{pid}/status") as f:
                return any(line.split()[1:2] == ["Z"] for line in f if line.startswith("State"))
        except FileNotFoundError:
            return True

    time.sleep(1.0)
    apps = _smi("compute-apps=pid")
    res["compute_apps_after"] = apps
    listed = {int(x) for x in apps.split() if x.strip().isdigit()}
    checks["nodes_gone"] = (bool(pids) and all(p is not None and gone(p) for p in pids)
                            and not listed & set(pids) and child.pid not in listed)
    res["checks"] = checks
    res["ok"] = all(checks.values())
    return res


def phase_process(dev="cuda") -> dict:
    """The process deployment on the card (module docstring, `process`):
    E + P + D as three spawned processes through ProcessCluster (each node
    builds LLaVA-1.5-7B from the seed), the EPD reference's tokens (the
    disagg phase's, else one EPD node's here, from the same factory), the
    D node's kill and respawn, the entry point with deployment=process as a
    child, and the context time-slicing probe."""
    import gc
    import torch
    from hydrainfer_tpu_torch.models.factory import ModelFactoryConfig, getModelFactory
    dev = torch.device(dev)
    gc.collect()
    torch.cuda.empty_cache()
    tokenizer = getModelFactory(ModelFactoryConfig(name=LLAVA_MODEL), "cpu").getTokenizer()
    reqs_warm, reqs = _disagg_requests(SEED + 6), _disagg_requests(SEED + 7)
    lone = _llava_requests(__import__("numpy").random.default_rng(SEED + 11), 1,
                           LLAVA_TOKENS, "lone")[0]
    general = asyncio.run(_process_general(dev, tokenizer, reqs_warm, reqs, lone))
    tokens = general.pop("tokens")
    factory = _LLAVA_MM.get("factory")
    epd_tokens = _LLAVA_MM.get("epd_tokens")
    ref_from = "disagg phase (one EPD node in process)"
    if epd_tokens is None:
        if factory is None:
            factory = _llava_factory_mm(dev)
        epd, _, epd_tokens = _disagg_topology(factory, "single.yaml", None, True)
        _LLAVA_MM.update(epd=epd)
        ref_from = "one EPD node in process, this phase"
    tie = _near_tie(factory.getLanguageModel(), factory.getTokenizer(), reqs, tokens,
                    epd_tokens, dev, vision=factory)
    general["tokens_identical_to_epd"] = tokens == epd_tokens
    general["divergences"] = tie
    general["reference"] = ref_from
    epd, inproc = _LLAVA_MM.get("epd", {}), _LLAVA_MM.get("general")
    general["beside"] = {k: {m: r.get(m) for m in ("tokens_per_s", "image_p50_ttft_s",
                                                   "text_p50_ttft_s")}
                         for k, r in (("epd_in_process", epd), ("general_in_process", inproc))
                         if r}
    _LLAVA_MM.clear()
    del factory
    gc.collect()
    torch.cuda.empty_cache()
    entry = _process_entrypoint()
    slicing = _timeslice()
    ok = all(general["checks"].values()) and tie["ok"] and entry["ok"]
    import multiprocessing
    import zmq
    result = {"phase": "process", "ok": bool(ok), "gpu": gpu_name_and_limit(),
              "pyzmq": zmq.__version__, "libzmq": zmq.zmq_version(),
              "start_methods": multiprocessing.get_all_start_methods(),   # the default first
              "model": LLAVA_MODEL + " (bf16 tower and projector, int8 weights, int8 KV),"
                       " built by each node process from the seed",
              "requests": f"{LLAVA_REQUESTS} image + {DISAGG_TEXT_REQUESTS} text "
                          f"({DISAGG_TEXT_PROMPT} tokens), {LLAVA_TOKENS} tokens each",
              "general": general, "entrypoint": entry, "timeslice": slicing}
    save("process.json", result)
    return result


# ------------------------------------------------- phases: llavanext, internvl

# the rounds' request seeds: the measured round's requests are rebuilt with
# the same content for the EP + D cluster
_MM_SEEDS = {"warm": SEED + 6, "measured": SEED + 7, "prof": SEED + 8}
# the llavanext phase's EP + D pools, per node type over DISAGG_NODE
NEXT_NODE = {"EP": {"n_kv_blocks": NEXT_KV_BLOCKS, "n_image_blocks": NEXT_IMAGE_BLOCKS},
             "D": {"n_kv_blocks": NEXT_KV_BLOCKS}}


def _mm_requests(images, seed, tag):
    """One request per (h, w) of `images`: seeded random pixels inside
    MM_TEXT text characters, MM_TOKENS tokens, greedy, ignore_eos; the same
    content for every call with the same seed."""
    import numpy as np
    from PIL import Image
    from hydrainfer_tpu_torch.request import Request, SamplingParameters
    rng = np.random.default_rng(seed)
    letters = list("abcdefghijklmnopqrstuvwxyz ")
    reqs = []
    for i, (h, w) in enumerate(images):
        img = Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
        text = "".join(rng.choice(letters, size=MM_TEXT))
        half = MM_TEXT // 2
        reqs.append(Request(request_id=f"{tag}{i}", prompt=text[:half] + "<image>" + text[half:],
                            image=img, sampling_params=SamplingParameters(
                                max_tokens=MM_TOKENS, ignore_eos=True)))
    return reqs


def _next_factory(dev, seed=SEED):
    """LLaVA-NeXT-13B at full width with random weights from the seed: the
    bf16 CLIP-L/14-336 tower to layer -2, the 1024 -> 5120 -> 5120 projector
    and a 5120-wide image_newline (seed + 1, + 2), llava-13b-lm with int8
    weights and int8 KV at 0.05, the default pinpoints, AnyresImageProcessor
    (PIL and numpy only)."""
    import torch
    from hydrainfer_tpu_torch.models.factory import VisionModelConfig
    from hydrainfer_tpu_torch.models.llavanext import (DEFAULT_PINPOINTS,
                                                       AnyresImageProcessor,
                                                       LlavaNextImageTokenCalculator,
                                                       LlavaNextVisionModel)
    from hydrainfer_tpu_torch.models.random_init import (CLIP_L_336, RandomWeightFactory,
                                                         init_clip_weights)
    lm_factory = RandomWeightFactory(NEXT_ARCH, dtype=torch.bfloat16, quantization="int8",
                                     kv_scale=0.05, device=dev, seed=seed)
    hidden = lm_factory.cfg.hidden_size
    vw = init_clip_weights(CLIP_L_336, seed + 1, torch.bfloat16, hidden, dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 2)
    vw["newline"] = (torch.randn(hidden, generator=gen, device=dev) * 0.02).to(torch.bfloat16)
    n_side = CLIP_L_336.image_size // CLIP_L_336.patch_size
    return _mm_factory(lm_factory, LlavaNextVisionModel(vw, CLIP_L_336, DEFAULT_PINPOINTS),
                       VisionModelConfig("<image>", 9, LlavaNextImageTokenCalculator(
                           DEFAULT_PINPOINTS, CLIP_L_336.image_size, n_side)),
                       AnyresImageProcessor(DEFAULT_PINPOINTS, CLIP_L_336.image_size))


def _internvl_factory(dev, seed=SEED):
    """InternVL2-8B at full width with random weights from the seed: the
    bf16 InternViT-300M-448px (INTERNVL_VIT; layer scales at 0.1, the HF
    init), the pixel shuffle and the mlp1 projector (LayerNorm(4096), 4096
    -> 4096, GELU, 4096 -> 4096; seed + 1), InternLM2.5-7B (INTERNLM2_7B)
    with int8 weights and int8 KV at 0.05; max_dynamic_patch 12 with the
    thumbnail; the port's InternVLImageProcessorAdapter."""
    import torch
    from hydrainfer_tpu_torch.models.decoder import DecoderConfig
    from hydrainfer_tpu_torch.models.factory import VisionModelConfig
    from hydrainfer_tpu_torch.models.internvl import (InternViTConfig,
                                                      InternVLImageProcessorAdapter,
                                                      InternVLImageTokenCalculator,
                                                      InternVLVisionModel)
    from hydrainfer_tpu_torch.models.random_init import RandomWeightFactory
    vcfg = InternViTConfig(**INTERNVL_VIT)
    # no random: name has InternLM2's shapes (the JAX package has none), so
    # the factory's architecture is replaced before it builds its weights
    lm_factory = RandomWeightFactory(NEXT_ARCH, dtype=torch.bfloat16, quantization="int8",
                                     kv_scale=0.05, device=dev, seed=seed)
    lm_factory.cfg = DecoderConfig(**INTERNLM2_7B)
    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    init = lambda *shape: (torch.randn(shape, generator=gen, device=dev) * 0.02).to(bf16)
    full = lambda n, x: torch.full((n,), x, dtype=bf16, device=dev)
    E, M, P = vcfg.hidden_size, vcfg.intermediate_size, vcfg.patch_size
    norm = lambda n: (full(n, 1.0), full(n, 0.0))
    vit = {"patch_embed": init(3 * P * P, E), "patch_bias": full(E, 0.0), "cls": init(E),
           "pos": init(vcfg.n_patches_side ** 2 + 1, E),
           "layers": [{"qkv": (init(E, 3 * E), full(3 * E, 0.0)),
                       "proj": (init(E, E), full(E, 0.0)), "ls1": full(E, 0.1),
                       "ls2": full(E, 0.1), "norm1": norm(E), "norm2": norm(E),
                       "fc1": (init(E, M), full(M, 0.0)), "fc2": (init(M, E), full(E, 0.0))}
                      for _ in range(vcfg.n_layers)]}
    d, hidden = 4 * E, lm_factory.cfg.hidden_size           # the 0.5 pixel shuffle
    weights = {"vit": vit, "proj_norm": norm(d), "proj1": (init(d, hidden), full(hidden, 0.0)),
               "proj2": (init(hidden, hidden), full(hidden, 0.0))}
    tokens_per_tile = int((vcfg.n_patches_side * 0.5) ** 2)
    return _mm_factory(lm_factory, InternVLVisionModel(weights, vcfg, 0.5),
                       VisionModelConfig("<image>", 9, InternVLImageTokenCalculator(
                           tokens_per_tile, vcfg.image_size, 12, True)),
                       InternVLImageProcessorAdapter(vcfg.image_size, 12))


def _tower_f32(vm):
    """The same tower with every weight in f32."""
    from hydrainfer_tpu_torch.models.deepseek_vl2 import DeepSeekVL2VisionModel
    from hydrainfer_tpu_torch.models.internvl import InternVLVisionModel
    from hydrainfer_tpu_torch.models.llavanext import LlavaNextVisionModel
    if isinstance(vm, LlavaNextVisionModel):
        return LlavaNextVisionModel(_f32_tree(vm.weights), vm.clip_cfg, vm.pinpoints,
                                    vm.select_strategy)
    if isinstance(vm, DeepSeekVL2VisionModel):
        return DeepSeekVL2VisionModel(_f32_tree(vm.weights), vm.cfg, vm.calc, vm.downsample,
                                      vm.global_view_pos)
    return InternVLVisionModel(_f32_tree(vm.weights), vm.cfg, vm.downsample_ratio)


def _mm_epd(name, path, factory, images, kv_blocks, image_blocks, feature_image,
            long_image, dev) -> tuple:
    """A tiling family on one EPD node at full width (OfflineEngine, budget
    MM_BUDGET, K = 16 windows, no speculation, boot warm-up): a warm-up, measured
    and profiled round of _mm_requests(images). Checks: every request
    finishes with its tokens; K1-K5 launch in the measured round and a K =
    16 window runs; an image prompt's prefill spans two or more steps; the
    tiles of image `feature_image` through K5 give the plain attention's
    features (_features_check: one image, since the plain attention forms
    (H, T, T)); the prefill of image `long_image`'s prompt in chunks of the
    budget gives the plain versions' logits in each chunk (read at every
    64th row and each chunk's last). Reports
    tokens/s, p50 TTFT, the encode walls, one whole-round encode's wall and
    device time, tiles and image tokens a round, peak memory and the LM
    steps (one lm_head launch each). Returns (result, the measured round's
    counts, its requests and tokens)."""
    import numpy as np
    import torch
    from hydrainfer_tpu_torch.models.factory import VisionModelParameters
    t0 = time.perf_counter()
    factory.getLanguageModel()
    vm = factory.getVisionModel()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    free = torch.cuda.mem_get_info(dev)[0]
    t0 = time.perf_counter()
    engine = _engine(factory, dev, len(images), 16, kv_blocks, MM_BUDGET, node_type="EPD",
                     n_image_blocks=image_blocks, spec_ngram_k=0)
    boot_s = time.perf_counter() - t0
    graphs = GraphRounds(engine, free)
    reqs, outs, rec = _image_rounds(
        engine, graphs,
        lambda tag: _mm_requests(images, _MM_SEEDS[tag], path if tag == "measured" else tag),
        f"{path}_profile.json")
    report = _round_report(outs, rec, MM_TOKENS, factory.cfg.vocab_size, graphs)
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    calc = factory.getVisionModelConfig().image_token_calculator
    proc = factory.getProcessor()
    sizes = [(r.image.height, r.image.width) for r in reqs]
    r = reqs[feature_image]
    features = _features_check(vm, _tower_f32(vm), proc.process(r.image),
                               VisionModelParameters(original_image_sizes=[sizes[feature_image]]),
                               len(vm.weights["clip"]["layers"]) if "clip" in vm.weights
                               else vm.cfg.n_layers)
    features["features_image"] = list(sizes[feature_image])
    features.update(_encode_profile(vm, np.concatenate([proc.process(x.image) for x in reqs]),
                                    VisionModelParameters(original_image_sizes=sizes)))
    logits = _image_prefill_check(factory, reqs[long_image], np.random.default_rng(SEED + 9),
                                  dev, chunk=MM_BUDGET, every=64)
    counts = rec["counts"]
    steps = rec["prefill_steps"]
    checks = {"tokens": report.pop("tokens_ok"), "features": features["features_ok"],
              "prefill_logits": logits.pop("ok"), "graphs": graphs.ok(),
              "k16_window": 16 in rec["windows"],
              "kernels_launched": all(counts[k] > 0 for k in VLM_KERNELS),
              "prefill_spans_steps": max(steps.values(), default=0) >= 2}
    c = factory.cfg
    result = {"phase": name, "ok": all(checks.values()), "checks": checks,
              "gpu": gpu_name_and_limit(),
              "vision": "bf16", "weights": "int8", "kv_cache": "int8 (scale 0.05)",
              "lm": {k: getattr(c, k) for k in ("n_layers", "hidden_size", "intermediate_size",
                                                "n_qo_heads", "n_kv_heads", "head_dim",
                                                "vocab_size")},
              "n_requests": len(images), "images": images,
              "tiles": [calc.n_tiles(hw) for hw in images],
              "image_tokens": [calc.get_num_image_tokens(hw) for hw in images],
              "tiles_a_round": sum(calc.n_tiles(hw) for hw in images),
              "image_tokens_a_round": sum(calc.get_num_image_tokens(hw) for hw in images),
              "prompt_text_chars": MM_TEXT, "max_tokens": MM_TOKENS, "token_budget": MM_BUDGET,
              "kv_blocks": kv_blocks, "image_blocks": image_blocks,
              "prefill_steps_per_image_request": steps,
              "lm_steps": rec["lm_steps"], "weight_init_s": init_s, "boot_s": boot_s,
              "lm_param_bytes": factory.lm_factory.param_bytes(), **report, **features,
              **logits}
    return result, counts, reqs, [o.output_token_ids for o in outs]


def _tiny_deepseek_tensors(family, rng) -> tuple:
    """_tiny_tensors of the DeepSeek families. deepseek: a DeepseekV3ForCausalLM
    in HF's names, 2 layers x 64, MLA with q-LoRA (rank 24; kv_lora 16, rope
    8, nope 16, v 16, 4 heads), the first layer dense, then 8 experts of 32
    in 4 groups, 2 a token under noaux_tc (sigmoid, a nonzero correction
    bias, the best 2 groups, scaling 2.5) and one shared; YaRN factor 2 over
    64 positions, mscale 1. deepseek_vl2: the original VL2 naming, SigLIP 2
    layers x 72 (2 heads of 36, padded to 48) over 28-pixel tiles, the
    depth-2 projector, a DeepSeek-V2 LM 2 layers x 64 (2 q / 1 kv heads,
    d32, the first layer dense, then 4 experts of 32, 2 a token, greedy
    softmax, one shared), candidates 28 x 28, 28 x 56, 56 x 28."""
    import numpy as np
    f = lambda *shape: (rng.standard_normal(shape) * 0.05).astype(np.float32)
    one = lambda n: np.ones(n, np.float32)
    zero = lambda n: np.zeros(n, np.float32)
    V, hid, t = 128, 64, {}
    lm = "model." if family == "deepseek" else "language.model."
    text = {"vocab_size": V, "hidden_size": hid, "intermediate_size": 128,
            "moe_intermediate_size": 32, "num_hidden_layers": 2, "n_shared_experts": 1,
            "first_k_dense_replace": 1, "max_position_embeddings": 256, "rms_norm_eps": 1e-6,
            "rope_theta": 10000.0, "eos_token_id": 63}
    if family == "deepseek":
        text.update(model_type="deepseek_v3", architectures=["DeepseekV3ForCausalLM"],
                    num_attention_heads=4, num_key_value_heads=4, n_routed_experts=8,
                    num_experts_per_tok=2, n_group=4, topk_group=2, topk_method="noaux_tc",
                    scoring_func="sigmoid", norm_topk_prob=True, routed_scaling_factor=2.5,
                    kv_lora_rank=16, q_lora_rank=24, qk_rope_head_dim=8, qk_nope_head_dim=16,
                    v_head_dim=16, rope_interleave=True,
                    rope_scaling={"type": "yarn", "factor": 2.0,
                                  "original_max_position_embeddings": 64, "mscale": 1.0,
                                  "mscale_all_dim": 1.0, "beta_fast": 32, "beta_slow": 1})
    else:
        text.update(model_type="deepseek_v2", num_attention_heads=2, num_key_value_heads=1,
                    n_routed_experts=4, num_experts_per_tok=2, topk_method="greedy",
                    scoring_func="softmax", norm_topk_prob=False, routed_scaling_factor=1.0)
    E, I = text["n_routed_experts"], 32
    t[lm + "embed_tokens.weight"], t[lm + "norm.weight"] = f(V, hid), one(hid)
    for i in range(2):
        p = f"{lm}layers.{i}."
        t[p + "input_layernorm.weight"] = t[p + "post_attention_layernorm.weight"] = one(hid)
        if family == "deepseek":
            t.update({p + "self_attn.q_a_proj.weight": f(24, hid),
                      p + "self_attn.q_a_layernorm.weight": one(24),
                      p + "self_attn.q_b_proj.weight": f(4 * 24, 24),
                      p + "self_attn.kv_a_proj_with_mqa.weight": f(24, hid),
                      p + "self_attn.kv_a_layernorm.weight": one(16),
                      p + "self_attn.kv_b_proj.weight": f(4 * 32, 16),
                      p + "self_attn.o_proj.weight": f(hid, 4 * 16)})
        else:
            t.update({p + "self_attn.q_proj.weight": f(64, hid),
                      p + "self_attn.k_proj.weight": f(32, hid),
                      p + "self_attn.v_proj.weight": f(32, hid),
                      p + "self_attn.o_proj.weight": f(hid, 64)})
        if i == 0:
            t.update({p + "mlp.gate_proj.weight": f(128, hid), p + "mlp.up_proj.weight": f(128, hid),
                      p + "mlp.down_proj.weight": f(hid, 128)})
            continue
        t[p + "mlp.gate.weight"] = f(E, hid)
        if family == "deepseek":
            t[p + "mlp.gate.e_score_correction_bias"] = rng.uniform(
                -0.05, 0.05, E).astype(np.float32)
        for e in range(E):
            q = f"{p}mlp.experts.{e}."
            t.update({q + "gate_proj.weight": f(I, hid), q + "up_proj.weight": f(I, hid),
                      q + "down_proj.weight": f(hid, I)})
        q = p + "mlp.shared_experts."
        t.update({q + "gate_proj.weight": f(I, hid), q + "up_proj.weight": f(I, hid),
                  q + "down_proj.weight": f(hid, I)})
    if family == "deepseek":
        t["lm_head.weight"] = f(V, hid)
        return t, text
    t["language.lm_head.weight"] = f(V, hid)
    C = 72
    t.update({"vision.patch_embed.proj.weight": f(C, 3, 14, 14),
              "vision.patch_embed.proj.bias": f(C), "vision.pos_embed": f(1, 4, C),
              "vision.norm.weight": one(C), "vision.norm.bias": zero(C),
              "projector.layers.0.weight": f(32, 4 * C), "projector.layers.0.bias": f(32),
              "projector.layers.2.weight": f(hid, 32), "projector.layers.2.bias": f(hid),
              "image_newline": f(hid), "view_seperator": f(hid)})
    for i in range(2):
        p = f"vision.blocks.{i}."
        for n in ("norm1", "norm2"):
            t[p + n + ".weight"], t[p + n + ".bias"] = one(C), zero(C)
        t.update({p + "attn.qkv.weight": f(3 * C, C), p + "attn.qkv.bias": f(3 * C),
                  p + "attn.proj.weight": f(C, C), p + "attn.proj.bias": f(C),
                  p + "mlp.fc1.weight": f(2 * C, C), p + "mlp.fc1.bias": f(2 * C),
                  p + "mlp.fc2.weight": f(C, 2 * C), p + "mlp.fc2.bias": f(C)})
    cfg = {"model_type": "deepseek_vl_v2", "global_view_pos": "head", "image_token_id": 60,
           "candidate_resolutions": [[28, 28], [28, 56], [56, 28]],
           "vision_config": {"params": {"width": C, "layers": 2, "heads": 2,
                                        "intermediate_size": 2 * C, "image_size": 28,
                                        "patch_size": 14}},
           "projector_config": {"depth": 2, "downsample_ratio": 2, "n_embed": 32},
           "language_config": text}
    return t, cfg


def _tiny_text_tensors(family, rng) -> tuple:
    """A tiny text-only checkpoint in transformers' names, vocab 128: Mixtral
    (2 layers x 64, 2 q / 1 kv heads of 32, 4 experts of 64, 2 a token; the
    router's weights 10x the others', so no routing choice is a near tie) or
    GPT-2 (2 layers x 64, 2 heads of 32, 256 positions, Conv1D weights (in,
    out) under `transformer.`, the head tied)."""
    import numpy as np
    f = lambda *shape: (rng.standard_normal(shape) * 0.05).astype(np.float32)  # noqa: E731
    one = lambda n: np.ones(n, np.float32)  # noqa: E731
    zero = lambda n: np.zeros(n, np.float32)  # noqa: E731
    V, d = 128, 64
    t = {}
    if family == "mixtral":
        t.update({"model.embed_tokens.weight": f(V, d), "lm_head.weight": f(V, d),
                  "model.norm.weight": one(d)})
        for i in range(2):
            p = f"model.layers.{i}."
            t.update({p + "self_attn.q_proj.weight": f(d, d),
                      p + "self_attn.k_proj.weight": f(32, d),
                      p + "self_attn.v_proj.weight": f(32, d),
                      p + "self_attn.o_proj.weight": f(d, d),
                      p + "input_layernorm.weight": one(d),
                      p + "post_attention_layernorm.weight": one(d),
                      p + "block_sparse_moe.gate.weight": 10 * f(4, d)})
            for e in range(4):
                x = f"{p}block_sparse_moe.experts.{e}."
                t.update({x + "w1.weight": f(64, d), x + "w3.weight": f(64, d),
                          x + "w2.weight": f(d, 64)})
        return t, {"architectures": ["MixtralForCausalLM"], "model_type": "mixtral",
                   "vocab_size": V, "hidden_size": d, "intermediate_size": 64,
                   "num_hidden_layers": 2, "num_attention_heads": 2, "num_key_value_heads": 1,
                   "num_local_experts": 4, "num_experts_per_tok": 2,
                   "max_position_embeddings": 256, "rms_norm_eps": 1e-5, "rope_theta": 1e6}
    p = "transformer."
    t.update({p + "wte.weight": f(V, d), p + "wpe.weight": f(256, d),
              p + "ln_f.weight": one(d), p + "ln_f.bias": zero(d)})
    for i in range(2):
        h = f"{p}h.{i}."
        t.update({h + "ln_1.weight": one(d), h + "ln_1.bias": zero(d),
                  h + "ln_2.weight": one(d), h + "ln_2.bias": zero(d),
                  h + "attn.c_attn.weight": f(d, 3 * d), h + "attn.c_attn.bias": f(3 * d),
                  h + "attn.c_proj.weight": f(d, d), h + "attn.c_proj.bias": f(d),
                  h + "mlp.c_fc.weight": f(d, 4 * d), h + "mlp.c_fc.bias": f(4 * d),
                  h + "mlp.c_proj.weight": f(4 * d, d), h + "mlp.c_proj.bias": f(d)})
    return t, {"architectures": ["GPT2LMHeadModel"], "model_type": "gpt2", "vocab_size": V,
               "n_embd": d, "n_layer": 2, "n_head": 2, "n_positions": 256}


def _tiny_tensors(family, rng) -> tuple:
    """A tiny checkpoint of `family` as numpy tensors and its config.json, in
    the layout the CPU tests load: LLaVA-NeXT with transformers' nested names
    (CLIP 3 layers x 32 wide over 28-pixel tiles, pinpoints (28, 56), (56,
    28), (56, 56)); InternVL in the original layout (InternViT 2 layers x 64
    over 56-pixel tiles, mlp1, an InternLM2 LM with fused wqkv). Both LMs:
    2 layers x 64, 2 q / 1 kv heads (d32), vocab 128 (the boot warm-up's
    prompts draw ids up to 99), image token 60. The DeepSeek families:
    _tiny_deepseek_tensors; Mixtral and GPT-2: _tiny_text_tensors."""
    import numpy as np
    if family in ("deepseek", "deepseek_vl2"):
        return _tiny_deepseek_tensors(family, rng)
    if family in ("mixtral", "gpt2"):
        return _tiny_text_tensors(family, rng)
    f = lambda *shape: (rng.standard_normal(shape) * 0.05).astype(np.float32)
    one = lambda n: np.ones(n, np.float32)
    zero = lambda n: np.zeros(n, np.float32)
    V = 128
    text = {"model_type": "llama", "vocab_size": V, "hidden_size": 64,
            "intermediate_size": 128, "num_hidden_layers": 2, "num_attention_heads": 2,
            "num_key_value_heads": 1, "max_position_embeddings": 256, "rms_norm_eps": 1e-6,
            "rope_theta": 10000.0}
    t = {}
    if family == "llavanext":
        C, I, L = 32, 64, 3
        v = "model.vision_tower.vision_model."
        t.update({v + "embeddings.patch_embedding.weight": f(C, 3, 14, 14),
                  v + "embeddings.class_embedding": f(C),
                  v + "embeddings.position_embedding.weight": f(5, C),
                  v + "pre_layrnorm.weight": one(C), v + "pre_layrnorm.bias": zero(C)})
        for i in range(L):
            p = f"{v}encoder.layers.{i}."
            for n in ("layer_norm1", "layer_norm2"):
                t[p + n + ".weight"], t[p + n + ".bias"] = one(C), zero(C)
            for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
                t[p + f"self_attn.{n}.weight"], t[p + f"self_attn.{n}.bias"] = f(C, C), f(C)
            t[p + "mlp.fc1.weight"], t[p + "mlp.fc1.bias"] = f(I, C), f(I)
            t[p + "mlp.fc2.weight"], t[p + "mlp.fc2.bias"] = f(C, I), f(C)
        mp = "model.multi_modal_projector."
        t.update({mp + "linear_1.weight": f(64, C), mp + "linear_1.bias": f(64),
                  mp + "linear_2.weight": f(64, 64), mp + "linear_2.bias": f(64),
                  "model.image_newline": f(64)})
        lm = "model.language_model."
        t[lm + "embed_tokens.weight"], t["lm_head.weight"] = f(V, 64), f(V, 64)
        t[lm + "norm.weight"] = one(64)
        for i in range(2):
            p = f"{lm}layers.{i}."
            t.update({p + "self_attn.q_proj.weight": f(64, 64),
                      p + "self_attn.k_proj.weight": f(32, 64),
                      p + "self_attn.v_proj.weight": f(32, 64),
                      p + "self_attn.o_proj.weight": f(64, 64),
                      p + "mlp.gate_proj.weight": f(128, 64), p + "mlp.up_proj.weight": f(128, 64),
                      p + "mlp.down_proj.weight": f(64, 128),
                      p + "input_layernorm.weight": one(64),
                      p + "post_attention_layernorm.weight": one(64)})
        cfg = {"architectures": ["LlavaNextForConditionalGeneration"],
               "image_token_index": 60, "vision_feature_layer": -2,
               "vision_feature_select_strategy": "default",
               "image_grid_pinpoints": [[28, 56], [56, 28], [56, 56]],
               "vision_config": {"hidden_size": C, "intermediate_size": I,
                                 "num_hidden_layers": L, "num_attention_heads": 2,
                                 "image_size": 28, "patch_size": 14},
               "text_config": text}
        return t, cfg
    E, M = 64, 128
    v = "vision_model."
    t.update({v + "embeddings.patch_embedding.weight": f(E, 3, 14, 14),
              v + "embeddings.patch_embedding.bias": f(E),
              v + "embeddings.class_embedding": f(1, 1, E),
              v + "embeddings.position_embedding": f(1, 17, E)})
    for i in range(2):
        p = f"{v}encoder.layers.{i}."
        t.update({p + "attn.qkv.weight": f(3 * E, E), p + "attn.qkv.bias": f(3 * E),
                  p + "attn.proj.weight": f(E, E), p + "attn.proj.bias": f(E),
                  p + "ls1": np.full(E, 0.1, np.float32), p + "ls2": np.full(E, 0.1, np.float32),
                  p + "norm1.weight": one(E), p + "norm1.bias": zero(E),
                  p + "norm2.weight": one(E), p + "norm2.bias": zero(E),
                  p + "mlp.fc1.weight": f(M, E), p + "mlp.fc1.bias": f(M),
                  p + "mlp.fc2.weight": f(E, M), p + "mlp.fc2.bias": f(E)})
    t.update({"mlp1.0.weight": one(4 * E), "mlp1.0.bias": zero(4 * E),
              "mlp1.1.weight": f(64, 4 * E), "mlp1.1.bias": f(64),
              "mlp1.3.weight": f(64, 64), "mlp1.3.bias": f(64)})
    lm = "language_model.model."
    t[lm + "tok_embeddings.weight"], t["language_model.output.weight"] = f(V, 64), f(V, 64)
    t[lm + "norm.weight"] = one(64)
    for i in range(2):
        p = f"{lm}layers.{i}."
        # one kv head: the wqkv rows [q_0, q_1, k, v], 32 each
        t.update({p + "attention.wqkv.weight": f(4 * 32, 64), p + "attention.wo.weight": f(64, 64),
                  p + "feed_forward.w1.weight": f(128, 64), p + "feed_forward.w3.weight": f(128, 64),
                  p + "feed_forward.w2.weight": f(64, 128), p + "attention_norm.weight": one(64),
                  p + "ffn_norm.weight": one(64)})
    cfg = {"architectures": ["InternVLChatModel"], "model_type": "internvl_chat",
           "downsample_ratio": 0.5, "image_token_id": 60, "max_dynamic_patch": 12,
           "use_thumbnail": True,
           "vision_config": {"hidden_size": E, "intermediate_size": M, "num_hidden_layers": 2,
                             "num_attention_heads": 4, "image_size": 56, "patch_size": 14},
           "llm_config": {**text, "architectures": ["InternLM2ForCausalLM"],
                          "model_type": "internlm2", "bias": False}}
    return t, cfg


def _tiny_checkpoint_check(family, devices=("cuda", "cpu")) -> dict:
    """A tiny checkpoint of `family` (_tiny_tensors) written with
    safetensors.numpy.save_file under a temporary directory, served through
    getModelFactory(path) in f32 on one EPD node on each of `devices` (the
    card and the CPU; budget 16, so the image prompt prefills in chunks): an
    image request and a text request, 8 tokens each; the greedy tokens must
    be equal. The text-only families (deepseek, mixtral, gpt2) serve two
    text requests on a PD node. A MoE model (DeepSeek, Mixtral) runs with
    CUDA graphs off: in f32 the grouped product reads its group sizes on the
    host (ops/moe.py). Without
    safetensors the check says so on a line of its own and is skipped."""
    import tempfile
    import numpy as np
    try:
        from safetensors.numpy import save_file
    except ImportError:
        print(f"chip_smoke: {family}: safetensors is absent; the tiny-checkpoint check "
              "is skipped", flush=True)
        return {"tiny_checkpoint": "skipped: safetensors absent"}
    from PIL import Image
    from hydrainfer_tpu_torch.models.factory import ModelFactoryConfig, getModelFactory
    from hydrainfer_tpu_torch.models.llavanext import AnyresImageProcessor
    from hydrainfer_tpu_torch.models.tokenizer import SimpleTokenizer
    from hydrainfer_tpu_torch.request import Request, SamplingParameters
    tensors, cfg = _tiny_tensors(family, np.random.default_rng(SEED + 11))
    size = {"llavanext": (50, 50), "deepseek_vl2": (28, 50)}.get(family, (112, 168))
    moe = family in ("deepseek", "deepseek_vl2", "mixtral")
    text_only = family in ("deepseek", "mixtral", "gpt2")
    tokens = []
    with tempfile.TemporaryDirectory() as tmp:
        save_file(tensors, os.path.join(tmp, "model.safetensors"))
        with open(os.path.join(tmp, "config.json"), "w") as fh:
            json.dump(cfg, fh)
        for device in devices:
            factory = getModelFactory(ModelFactoryConfig(path=tmp, dtype="fp32"), device)
            factory.getTokenizer = lambda: SimpleTokenizer(image_token_id=60, eos_token_id=63)
            if family == "llavanext":
                factory.getProcessor = lambda: AnyresImageProcessor(
                    cfg["image_grid_pinpoints"], 28)
            engine = _engine(factory, device, 2, 16, 128, 16,
                             node_type="PD" if text_only else "EPD",
                             n_image_blocks=-1 if text_only else 8, spec_ngram_k=0,
                             cuda_graphs=not moe)
            rng = np.random.default_rng(SEED + 12)
            img = Image.fromarray(rng.integers(0, 256, (*size, 3), dtype=np.uint8))
            sp = lambda: SamplingParameters(max_tokens=8, ignore_eos=True)
            outs = engine.generate([
                Request(request_id="m", prompt="&% !!%& %" if text_only else "<image> !%&!",
                        image=None if text_only else img, sampling_params=sp()),
                Request(request_id="t", prompt="!! % &&", sampling_params=sp())],
                timeout_s=300)
            tokens.append([o.output_token_ids for o in outs])
            del engine, factory
    return {"tiny_checkpoint": {"tokens": dict(zip(devices, tokens)),
                                "image": None if text_only else list(size),
                                "ok": tokens[0] == tokens[1]
                                and all(len(x) == 8 for x in tokens[0])}}


def phase_llavanext(dev="cuda") -> tuple:
    """LLaVA-NeXT-13B at full width (_next_factory) on one EPD node
    (_mm_epd: NEXT_IMAGES, 34 tiles and 18792 image tokens a round; the
    features of the 672 x 672 image, the chunked prefill of its 2992-token
    prompt), then the same requests on an in-process Cluster from
    config/cluster/hybrid.yaml (EP + D, one shared factory, NEXT_NODE's
    pools): every request finishes with its tokens, equal to the EPD node's
    or first differing at a near tie (_near_tie); the first migrated KV
    blocks equal the source's bit for bit; every node launches its type's
    kernels (DISAGG_LAUNCH) and ends with no request migrating and its
    blocks back (_disagg_topology). Then the tiny-checkpoint check."""
    import torch
    dev = torch.device(dev)
    factory = _next_factory(dev)
    result, counts, reqs, epd_tokens = _mm_epd("llavanext", "next13b", factory, NEXT_IMAGES,
                                               NEXT_KV_BLOCKS, NEXT_IMAGE_BLOCKS, 0, 0, dev)
    result["model"] = ("LLaVA-NeXT-13B (llava-v1.6-vicuna-13b shapes): CLIP-L/14-336, 23 "
                       "layers, 577 rows a tile, default pinpoints; projector 1024 -> 5120 -> "
                       f"5120, image_newline 5120; LM {NEXT_ARCH}")
    hybrid, _, tokens = _disagg_topology(
        factory, "hybrid.yaml", None, True,
        make_requests=lambda seed: _mm_requests(NEXT_IMAGES, seed, "ep_d"), overlay=NEXT_NODE)
    gc.collect()
    torch.cuda.empty_cache()
    tie = _near_tie(factory.getLanguageModel(), factory.getTokenizer(), reqs, tokens,
                    epd_tokens, dev, vision=factory)
    hybrid["tokens_identical_to_epd"] = tokens == epd_tokens
    hybrid["divergences"] = tie
    hybrid["ok"] = bool(hybrid["ok"] and tie["ok"])
    result["ep_d"] = hybrid
    result.update(_tiny_checkpoint_check("llavanext"))
    tiny = result["tiny_checkpoint"]
    result["ok"] = bool(result["ok"] and hybrid["ok"]
                        and (not isinstance(tiny, dict) or tiny["ok"]))
    save("llavanext.json", result)
    return result, counts


def phase_internvl(dev="cuda") -> tuple:
    """InternVL2-8B at full width (_internvl_factory) on one EPD node
    (_mm_epd: INTERNVL_IMAGES, 48 tiles and 12288 image tokens a round; the
    features of a 7-tile image, the chunked prefill of the 13-tile image's
    3392-token prompt). Reports K4's lm_head launches at N = 92553 (one a
    LM step). Then the tiny-checkpoint check."""
    import torch
    dev = torch.device(dev)
    factory = _internvl_factory(dev)
    result, counts, _, _ = _mm_epd("internvl", "internvl", factory, INTERNVL_IMAGES,
                                   INTERNVL_KV_BLOCKS, INTERNVL_IMAGE_BLOCKS, 2, 3, dev)
    result["model"] = ("InternVL2-8B: InternViT-300M-448px (24 layers x 1024, 16 heads, "
                       "1025 rows a tile), pixel shuffle 0.5 (256 tokens a tile), mlp1 "
                       "4096 -> 4096 -> 4096; LM InternLM2.5-7B (32 layers, 4096, 32 q / 8 kv "
                       "heads, vocab 92553)")
    result["lm_head_launches"] = {"N": factory.cfg.vocab_size, "launches": result["lm_steps"]}
    result.update(_tiny_checkpoint_check("internvl"))
    tiny = result["tiny_checkpoint"]
    result["ok"] = bool(result["ok"] and (not isinstance(tiny, dict) or tiny["ok"]))
    save("internvl.json", result)
    return result, counts


# ------------------------------------------------- phases: deepseek, vl2

def _moe_lm_factory(dev, text_cfg: dict, seed=SEED, n_layers=0):
    """A MoE language model at the widths of `text_cfg` (a config.json text
    config, read by the port's deepseek_decoder_config, or for model_type
    mixtral by mixtral_decoder_config) with random weights from the seed,
    N(0, 0.02^2), built a layer at a time: MLA (plain q) or fused-qkv
    attention, the first first_k_dense_replace layers dense, then the router
    (hidden, E), the stacked experts (E, hidden, 2I) and (E, I, hidden) and
    the shared experts, if any, as gate_up / down; int8 as quantize_tree
    picks (o_proj, qkv, the dense and shared MLPs, lm_head: the experts, the
    router and MLA's q and latent projections stay bf16), int8 KV at 0.05.
    n_layers > 0 cuts the depth to that many layers. A RandomWeightFactory
    over those weights (its architecture replaced, as _internvl_factory
    does)."""
    from dataclasses import replace
    import torch
    from hydrainfer_tpu_torch.models.deepseek_v3 import deepseek_decoder_config
    from hydrainfer_tpu_torch.models.mixtral import mixtral_decoder_config
    from hydrainfer_tpu_torch.models.random_init import RandomWeightFactory
    from hydrainfer_tpu_torch.ops.quant import quantize_tree
    if text_cfg.get("model_type") == "mixtral":
        cfg, I = mixtral_decoder_config(text_cfg), text_cfg["intermediate_size"]
    else:
        cfg, I = deepseek_decoder_config(text_cfg), text_cfg["moe_intermediate_size"]
    if n_layers:
        cfg = replace(cfg, n_layers=n_layers)
    gen = torch.Generator(device=dev).manual_seed(seed)
    bf16 = torch.bfloat16
    init = lambda *shape: (torch.randn(shape, generator=gen, device=dev) * 0.02).to(bf16)
    ones = lambda n: torch.ones(n, dtype=bf16, device=dev)
    H, E, Hq = cfg.hidden_size, cfg.n_experts, cfg.n_qo_heads
    shared = I * text_cfg.get("n_shared_experts", 0)
    layers = []
    for layer in range(cfg.n_layers):
        if cfg.mla_kv_lora:
            r, dr, dn, dv = cfg.mla_kv_lora, cfg.mla_rope_dim, cfg.mla_nope_dim, cfg.mla_v_dim
            lw = {"q_proj": init(H, Hq * (dn + dr)), "kv_a": init(H, r + dr),
                  "kv_a_norm": ones(r), "w_uk": init(r, Hq, dn), "w_uv": init(r, Hq, dv),
                  "o_proj": init(Hq * dv, H)}
        else:
            D, kvh = cfg.head_dim, cfg.n_kv_heads
            lw = {"qkv_proj": init(H, (Hq + 2 * kvh) * D), "o_proj": init(Hq * D, H)}
        lw.update(input_norm=ones(H), post_norm=ones(H))
        if layer < text_cfg.get("first_k_dense_replace", 0):
            lw.update(gate_up=init(H, 2 * cfg.intermediate_size),
                      down=init(cfg.intermediate_size, H))
        else:
            lw.update(moe_router=init(H, E), moe_gate_up=init(E, H, 2 * I),
                      moe_down=init(E, I, H))
            if shared:
                lw.update(gate_up=init(H, 2 * shared), down=init(shared, H))
        layers.append(quantize_tree({"layers": [lw]}, "int8")["layers"][0])
    weights = quantize_tree({"embed": init(cfg.vocab_size, H), "layers": layers,
                             "norm": ones(H), "lm_head": init(H, cfg.vocab_size)}, "int8")
    factory = RandomWeightFactory("tiny-lm", dtype=bf16, quantization="int8", kv_scale=0.05,
                                  device=dev, seed=seed, weights=weights)
    factory.cfg = cfg
    return factory


class RouteSpy:
    """Wraps the decoder's MoE routing (models/decoder.py:_route). It keeps
    the expert ids of the last `keep` calls made outside a graph capture
    with exactly `decode_rows` rows (the decode steps of a full batch: one
    row a sequence); while `record` is a list, it collects every call's ids
    and the score gap between the top-k-th and the next choice instead."""

    def __init__(self, keep: int, decode_rows: int):
        from collections import deque
        from hydrainfer_tpu_torch.models import decoder
        self.decoder, self.orig = decoder, decoder._route
        self.decode = deque(maxlen=keep)
        self.decode_rows = decode_rows
        self.record = None

        def spy(h, lw, cfg):
            import torch
            from hydrainfer_tpu_torch.ops import moe
            weights, idx = self.orig(h, lw, cfg)
            if self.record is not None:
                scores = moe.route_scores(self.decoder.router_logits(h, lw), cfg.moe_scoring)
                top = torch.topk(scores, cfg.moe_top_k + 1, dim=-1).values
                self.record.append((idx.clone(), top[:, -2] - top[:, -1]))
            elif (h.shape[0] == self.decode_rows
                  and not torch.cuda.is_current_stream_capturing()):
                self.decode.append(idx.clone())
            return weights, idx

        decoder._route = spy

    def restore(self) -> None:
        self.decoder._route = self.orig

    def distinct_experts(self, n_moe_layers: int) -> dict:
        """Distinct experts per MoE layer in each of the last decode steps
        kept (consecutive groups of n_moe_layers calls)."""
        calls = list(self.decode)
        calls = calls[len(calls) % n_moe_layers:]
        steps = [[int(c.unique().numel()) for c in calls[i:i + n_moe_layers]]
                 for i in range(0, len(calls), n_moe_layers)]
        flat = [n for st in steps for n in st]
        return {"rows": int(calls[-1].shape[0]) if calls else 0, "steps": len(steps),
                "per_layer_last_step": steps[-1] if steps else [],
                "mean": sum(flat) / len(flat) if flat else None,
                "min": min(flat, default=None), "max": max(flat, default=None)}


def _routing_flips(lm, tokens, dev, spy) -> dict:
    """One bf16 prefill through the kernels and through the plain versions:
    the (token, MoE layer) routing choices whose expert sets differ, each
    with the plain path's gap between its top-k-th and (k+1)-th score (a flip
    at a near tie is not a fault: the two paths round differently), and the
    flips of the first layer that flips, the near-tie test."""
    import torch
    runs = []
    with torch.no_grad():
        for fn in (_prefill_logits, _plain_logits):
            spy.record = []
            fn(lm, tokens, dev)
            runs.append(spy.record)
    spy.record = None
    return _flip_report(runs, len(tokens))


def _flip_report(runs, n_tokens: int) -> dict:
    """The routing choices of two runs of one prefill ([(expert ids, score
    gap)] a MoE layer each) that differ, with the second run's gap between
    its top-k-th and (k+1)-th score, and the first flipped layer's."""
    flips = []
    for layer, ((a, _), (b, gap)) in enumerate(zip(*runs)):
        differ = (a.sort(dim=-1).values != b.sort(dim=-1).values).any(dim=-1)
        for t in differ.nonzero().flatten().tolist():
            flips.append({"layer": layer, "token": t, "gap": float(gap[t])})
    gaps = [f["gap"] for f in flips]
    # the near-tie test is the first layer that flips: up to it the two paths'
    # inputs differ by rounding alone; after it a flipped token's state, and
    # through attention every later token's, differs, and flips at any gap
    first = [f for f in flips if f["layer"] == flips[0]["layer"]] if flips else []
    return {"routing_choices": len(runs[1]) * n_tokens, "routing_flips": len(flips),
            "routing_flip_gaps": sorted(gaps)[:20], "routing_flip_max_gap": max(gaps, default=None),
            "routing_flips_first": flips[:10],
            "routing_first_flipped_layer": first[0]["layer"] if first else None,
            "routing_first_layer_flips": len(first),
            "routing_first_layer_max_gap": max((f["gap"] for f in first), default=None)}


def _moe_logits(spy):
    """A MoE phase's logits_fn: a 512-token prefill in chunks of 256 through
    the kernels and through the plain versions at every layer, the f32
    reference built a layer at a time (_logits_check, layered; mean |error|
    over every 32nd row), and the routing choices that differ between the
    two paths in the bf16 prefill of its first 256 tokens."""
    def logits(lm, rng, dev):
        import torch
        tokens = [int(t) for t in rng.integers(10, 120, size=512)]
        res = _logits_check(lm, tokens, dev, "prefill_logits", mean_rows=True, layered=True,
                            chunk=256, every=32)
        res["prefill_logits_layers"] = lm.cfg.n_layers
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        res.update(_routing_flips(lm, tokens[:256], dev, spy))
        res["routing_flips_s"] = time.perf_counter() - t0
        return res
    return logits


def _moe_extra(factory, spy, n_moe: int, n_requests: int):
    """A MoE phase's extra_fn: the decode step's device ms (the widest K = 16
    window's graph replay over 16) beside its byte bound (the weights a step
    reads: the experts the eager round's last decode step touched, the rest
    whole but the embedding; KV not counted), and the distinct experts a MoE
    layer's decode step touches."""
    def extra(engine, graphs, lm):
        cfg = lm.cfg
        experts = spy.distinct_experts(n_moe)
        keys = [(d, n, g) for (d, n), g in graphs.graphs.graphs.items() if n == 16]
        d, n, g = max(keys, key=lambda x: x[0].S)
        step_ms = _replay_ms(g.graph, replays=5) / n
        lw = lm.weights["layers"][-1]
        expert_bytes = sum(lw[k].numel() * lw[k].element_size()
                           for k in ("moe_gate_up", "moe_down")) // cfg.n_experts
        touched = experts["per_layer_last_step"]
        embed = lm.weights["embed"]
        n_bytes = (factory.param_bytes() - embed.numel() * embed.element_size()
                   - n_moe * cfg.n_experts * expert_bytes + sum(touched) * expert_bytes)
        return {"ok": bool(touched) and experts["rows"] == n_requests,
                "decode_step_device_ms": step_ms, "decode_step_key": f"T={d.T} S={d.S}",
                "decode_step_bound_ms": 1e3 * n_bytes / HBM_BYTES_PER_S,
                "decode_step_bound_bytes": n_bytes,
                "distinct_experts_per_decode_step": experts}
    return extra


def phase_deepseek(dev="cuda") -> tuple:
    """DeepSeek-V2-Lite at full width (DEEPSEEK_V2_LITE, seeded random weights,
    _moe_lm_factory: 27 layers, MLA on the int8 single-plane latent cache,
    64 routed experts through the grouped product, YaRN), served as the mla
    phase serves mla-2b-lm (phase_serve: 32 requests x 128-token prompts x
    32 tokens, budget 2048, K = 16 windows from CUDA graphs; K6, K3 and K4
    launch, K1 and K2 never; a graphs-off round gives identical tokens; it
    is not profiled: the profiler's bookkeeping of an eager round's ~10^6
    events takes minutes).
    Logits (_moe_logits): a 512-token prefill in chunks of 256 through the
    kernels and the plain versions at all 27 layers, the f32 reference built
    a layer at a time, and the routing choices that differ between the two
    paths in the bf16 prefill. Reports the decode step's device ms beside
    its byte bound and the distinct experts a MoE layer's decode step
    touches (_moe_extra), and the tiny-checkpoint check (q-LoRA, noaux_tc
    with a correction bias, YaRN; f32 on the card with graphs off and on the
    CPU)."""
    import torch
    dev = torch.device(dev)
    t0 = time.perf_counter()
    factory = _moe_lm_factory(dev, DEEPSEEK_V2_LITE)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    cfg = factory.cfg
    n_moe = cfg.n_layers - DEEPSEEK_V2_LITE["first_k_dense_replace"]
    spy = RouteSpy(4 * n_moe, DEEPSEEK_REQUESTS)
    try:
        result, counts = phase_serve(
            "deepseek-v2-lite", dev, DEEPSEEK_REQUESTS, DEEPSEEK_PROMPT, DEEPSEEK_TOKENS, 2048,
            phase="deepseek", must_run=MLA_KERNELS + ("grouped_mm",),
            must_not_run=("mha_decode", "paged_attention"), eager_round=True,
            factory=factory, logits_fn=_moe_logits(spy),
            extra_fn=_moe_extra(factory, spy, n_moe, DEEPSEEK_REQUESTS), eager_profile=False)
    finally:
        spy.restore()
    result["weight_init_s"] = init_s
    result["model"] = ("DeepSeek-V2-Lite (deepseek-ai/DeepSeek-V2-Lite widths and depth): "
                       "27 layers x 2048, MLA 16 heads (kv_lora 512 + rope 64), YaRN x40, "
                       "1 dense layer (10944), 26 MoE layers of 64 x 1408 experts (6 a "
                       "token) + 2 shared, vocab 102400")
    del factory
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    result.update(_tiny_checkpoint_check("deepseek"))
    result["parts_s"]["tiny_checkpoint"] = time.perf_counter() - t0
    tiny = result["tiny_checkpoint"]
    result["ok"] = bool(result["ok"] and (not isinstance(tiny, dict) or tiny["ok"]))
    save("deepseek.json", result)
    return result, counts


def phase_mixtral(dev="cuda") -> tuple:
    """Mixtral-8x7B at its published widths, MIXTRAL_LAYERS of 32 layers
    (MIXTRAL_8X7B, seeded random weights, _moe_lm_factory: GQA 4:1 x d128
    over the int8 KV cache, every layer 8 routed experts of 14336 through the
    grouped product, 2 a token; int8 qkv, o_proj and lm_head, the experts
    and the router bf16), served as the deepseek phase serves V2-Lite
    (phase_serve: 32 requests x 128-token prompts x 32 tokens, budget 2048,
    K = 16 windows from CUDA graphs; K1-K4 and the grouped product launch; a
    graphs-off round gives identical tokens, not profiled). Logits at all 20
    layers, the f32 reference a layer at a time, and the routing flips
    (_moe_logits); the decode step's device ms beside its byte bound
    (_moe_extra); then the tiny-checkpoint check (f32, on the card with
    graphs off and on the CPU)."""
    import torch
    dev = torch.device(dev)
    t0 = time.perf_counter()
    factory = _moe_lm_factory(dev, MIXTRAL_8X7B, n_layers=MIXTRAL_LAYERS)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    spy = RouteSpy(4 * MIXTRAL_LAYERS, MIXTRAL_REQUESTS)
    try:
        result, counts = phase_serve(
            "mixtral-8x7b", dev, MIXTRAL_REQUESTS, MIXTRAL_PROMPT, MIXTRAL_TOKENS, 2048,
            phase="mixtral", must_run=SERVE_KERNELS + ("grouped_mm",), eager_round=True,
            factory=factory, logits_fn=_moe_logits(spy),
            extra_fn=_moe_extra(factory, spy, MIXTRAL_LAYERS, MIXTRAL_REQUESTS),
            eager_profile=False)
    finally:
        spy.restore()
    result["weight_init_s"] = init_s
    result["model"] = (f"Mixtral-8x7B (mistralai/Mixtral-8x7B-v0.1 widths), {MIXTRAL_LAYERS} "
                       "of 32 layers (the depth cut: bf16 experts are 2.82 GB a layer, 90 GB "
                       "at 32) x 4096, 32 q / 8 kv heads x 128, 8 experts of 14336 (2 a "
                       "token), vocab 32000, rope_theta 1e6; int8 qkv/o/lm_head, bf16 "
                       "experts and router")
    del factory
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    result.update(_tiny_checkpoint_check("mixtral"))
    result["parts_s"]["tiny_checkpoint"] = time.perf_counter() - t0
    tiny = result["tiny_checkpoint"]
    result["ok"] = bool(result["ok"] and (not isinstance(tiny, dict) or tiny["ok"]))
    save("mixtral.json", result)
    return result, counts


class _GPT2Factory:
    """GPT-2 XL at its published widths (GPT2_XL) with random weights from
    the seed, N(0, 0.02^2) (biases too; the layer norms' weights 1 and
    biases 0), bf16, built a layer at a time on the card; the node's view
    from the port's gpt2_language_config, the SimpleTokenizer."""

    def __init__(self, dev, seed=SEED):
        import torch
        from hydrainfer_tpu_torch.models.gpt2 import GPT2ForCausalLM
        self.cfg = c = _gpt2_cfg()
        gen = torch.Generator(device=dev).manual_seed(seed)
        bf16 = torch.bfloat16
        init = lambda *shape: (torch.randn(shape, generator=gen, device=dev)  # noqa: E731
                               * 0.02).to(bf16)
        norm = lambda: (torch.ones(c.hidden_size, dtype=bf16, device=dev),  # noqa: E731
                        torch.zeros(c.hidden_size, dtype=bf16, device=dev))
        H = c.hidden_size
        pair = lambda k, n: (init(k, n), init(n))  # noqa: E731
        weights = {"wte": init(c.vocab_size, H), "wpe": init(c.max_position_embeddings, H),
                   "layers": [{"ln1": norm(), "c_attn": pair(H, 3 * H), "c_proj": pair(H, H),
                               "ln2": norm(), "c_fc": pair(H, 4 * H),
                               "c_proj2": pair(4 * H, H)} for _ in range(c.n_layers)],
                   "ln_f": norm()}
        self.lm = GPT2ForCausalLM(weights, c)

    def getLanguageModel(self):
        return self.lm

    def getLanguageModelConfig(self):
        from hydrainfer_tpu_torch.models.gpt2 import gpt2_language_config
        return gpt2_language_config(self.cfg)

    def getVisionModel(self):
        return None

    def getVisionModelConfig(self):
        return None

    def getProcessor(self):
        return None

    def getTokenizer(self):
        from hydrainfer_tpu_torch.models.tokenizer import SimpleTokenizer
        return SimpleTokenizer()

    def param_bytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in _leaves(self.lm.weights))


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    return [tree]


def phase_gpt2(dev="cuda") -> tuple:
    """GPT-2 XL at full width and depth (_GPT2Factory: 48 layers x 1600, 25
    heads of 64, bf16 weights and a bf16 KV cache), served through
    OfflineEngine as phase_serve serves a text model: 32 requests x
    128-token prompts x 32 tokens, budget 2048, single-step windows (GPT-2
    takes no fused window) from CUDA graphs; K1, K2 and K3 launch, K4 never;
    a graphs-off round gives identical tokens (not profiled). Logits: a
    512-token prefill in chunks of 256 at full depth through the kernels and
    the plain versions (_logits_check, mean |error| over every 32nd row). The
    decode step's device ms beside its byte bound. Then the tiny-checkpoint
    check (f32, graphs on, on the card and on the
    CPU)."""
    import torch
    dev = torch.device(dev)
    t0 = time.perf_counter()
    factory = _GPT2Factory(dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0

    def logits(lm, rng, dev):
        tokens = [int(t) for t in rng.integers(10, 120, size=512)]
        return _logits_check(lm, tokens, dev, "prefill_logits", mean_rows=True, chunk=256,
                             every=32)

    def extra(engine, graphs, lm):
        """The widest decode key's graph replay beside its byte bound: the
        layers' weights and the f32 tied head read once (the embedding rows
        and the KV not counted)."""
        d, g = max(((d, g) for (d, _), g in graphs.graphs.graphs.items() if d.max_q == 1),
                   key=lambda x: x[0].S)
        n_bytes = sum(t.numel() * t.element_size()
                      for t in _leaves([lm.weights["layers"], lm.weights["ln_f"], lm.head]))
        return {"decode_step_device_ms": _replay_ms(g.graph), "decode_step_key":
                f"T={d.T} S={d.S}", "decode_step_bound_ms": 1e3 * n_bytes / HBM_BYTES_PER_S,
                "decode_step_bound_bytes": n_bytes}

    result, counts = phase_serve(
        "gpt2-xl", dev, GPT2_REQUESTS, GPT2_PROMPT, GPT2_TOKENS, 2048, phase="gpt2",
        must_run=("mha_decode", "paged_attention", "kv_writer"),
        must_not_run=("quant_matmul", "grouped_mm"), eager_round=True, factory=factory,
        logits_fn=logits, extra_fn=extra, eager_profile=False, window=1,
        precision=("bf16", "bf16"))
    result["weight_init_s"] = init_s
    result["model"] = ("GPT-2 XL (openai-community/gpt2-xl widths and depth): 48 layers x "
                       "1600, 25 heads x 64, MLP 6400 (tanh GELU), vocab 50257, 1024 "
                       "learned positions, tied f32 head")
    del factory
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    result.update(_tiny_checkpoint_check("gpt2"))
    result["parts_s"]["tiny_checkpoint"] = time.perf_counter() - t0
    tiny = result["tiny_checkpoint"]
    result["ok"] = bool(result["ok"] and (not isinstance(tiny, dict) or tiny["ok"]))
    save("gpt2.json", result)
    return result, counts


def _vl2_factory(dev, seed=SEED):
    """DeepSeek-VL2-Tiny at full width with random weights from the seed: the
    bf16 SigLIP-so400m tower (VL2_VISION; heads padded 72 -> 80 when the
    model is built), the 4608 -> 1280 -> 1280 projector, image_newline and
    view_seperator (seed + 1), the VL2_TINY_LM language model
    (_moe_lm_factory), the default six candidate resolutions and the
    port's processor (PIL and numpy)."""
    import torch
    from hydrainfer_tpu_torch.models.deepseek_vl2 import (
        DEFAULT_CANDIDATES, DeepSeekVL2ImageProcessorAdapter, DeepSeekVL2ImageTokenCalculator,
        DeepSeekVL2VisionModel, SigLIPConfig)
    from hydrainfer_tpu_torch.models.factory import VisionModelConfig
    lm_factory = _moe_lm_factory(dev, VL2_TINY_LM, seed)
    vcfg = SigLIPConfig(**VL2_VISION)
    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    init = lambda *shape: (torch.randn(shape, generator=gen, device=dev) * 0.02).to(bf16)
    full = lambda n, x: torch.full((n,), x, dtype=bf16, device=dev)
    E, M, P = vcfg.hidden_size, vcfg.intermediate_size, vcfg.patch_size
    norm = lambda n: (full(n, 1.0), full(n, 0.0))
    vit = {"patch_embed": init(3 * P * P, E), "patch_bias": full(E, 0.0),
           "pos": init(vcfg.n_patches_side ** 2, E), "norm": norm(E),
           "layers": [{"ln1": norm(E), "qkv": (init(E, 3 * E), full(3 * E, 0.0)),
                       "proj": (init(E, E), full(E, 0.0)), "ln2": norm(E),
                       "fc1": (init(E, M), full(M, 0.0)), "fc2": (init(M, E), full(E, 0.0))}
                      for _ in range(vcfg.n_layers)]}
    hidden = lm_factory.cfg.hidden_size
    weights = {"vit": vit, "proj": [(init(4 * E, VL2_N_EMBED), full(VL2_N_EMBED, 0.0)),
                                    (init(VL2_N_EMBED, hidden), full(hidden, 0.0))],
               "newline": init(hidden), "view_sep": init(hidden)}
    calc = DeepSeekVL2ImageTokenCalculator(DEFAULT_CANDIDATES, vcfg.image_size, P, 2)
    return _mm_factory(lm_factory, DeepSeekVL2VisionModel(weights, vcfg, calc),
                       VisionModelConfig("<image>", 9, calc),
                       DeepSeekVL2ImageProcessorAdapter(calc))


def _siglip_tflop(n_tiles: int) -> float:
    """The operations of an encode of n_tiles tiles: SigLIP's patch
    embedding, 27 layers (qkv, proj, the MLP, the attention's two products
    at the real head dim) and the projector, 2 per multiply-add."""
    c = VL2_VISION
    L, E, M = (math.ceil(c["image_size"] / c["patch_size"])) ** 2, c["hidden_size"], \
        c["intermediate_size"]
    layer = 2 * L * E * 3 * E + 2 * L * E * E + 4 * L * E * M + 4 * L * L * E
    embed = 2 * L * 3 * c["patch_size"] ** 2 * E
    proj = 2 * (L // 4) * (4 * E * VL2_N_EMBED + VL2_N_EMBED * VL2_TINY_LM["hidden_size"])
    return n_tiles * (c["n_layers"] * layer + embed + proj) / 1e12


def phase_vl2(dev="cuda") -> tuple:
    """DeepSeek-VL2-Tiny at full width (_vl2_factory) on one EPD node (_mm_epd:
    VL2_IMAGES, 28 tiles and 5776 image tokens a round; the features of the
    768 x 768 image through K5 and the plain attention, the 1055-token
    prompt of that image, K1-K5 launched), then the same requests on an
    in-process Cluster from config/cluster/hybrid.yaml (EP + D, one shared
    factory): every request finishes with its tokens, equal to the EPD
    node's or first differing at a near tie; the first migrated KV blocks
    equal the source's bit for bit; every node launches its type's kernels.
    Reports the round's encode against the tower's operations. Then the
    tiny-checkpoint check (the original VL2 naming; f32 on the card with
    graphs off and on the CPU)."""
    import torch
    dev = torch.device(dev)
    t0 = time.perf_counter()
    factory = _vl2_factory(dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    result, counts, reqs, epd_tokens = _mm_epd("vl2", "vl2", factory, VL2_IMAGES,
                                               VL2_KV_BLOCKS, VL2_IMAGE_BLOCKS, 1, 1, dev)
    result["weight_init_s"] = init_s
    result["model"] = ("DeepSeek-VL2-Tiny (deepseek-ai/deepseek-vl2-tiny widths): "
                       "SigLIP-so400m-384 (27 layers x 1152, 16 heads of 72 padded to 80, "
                       "784 rows a tile), projector 4608 -> 1280 -> 1280 (196 tokens a "
                       "tile); LM 12 layers x 1280, 10 MHA heads x 128, 1 dense layer "
                       "(6848), 11 MoE layers of 64 x 896 experts (6 a token) + 2 shared, "
                       "vocab 129280")
    tflop = _siglip_tflop(result["tiles_a_round"])
    result["encode_tflop_a_round"] = tflop
    if result.get("encode_profile_device_ms"):
        result["encode_tflops_per_s"] = tflop / (result["encode_profile_device_ms"] / 1e3)
    overlay = {"EP": {"n_kv_blocks": VL2_KV_BLOCKS, "n_image_blocks": VL2_IMAGE_BLOCKS},
               "D": {"n_kv_blocks": VL2_KV_BLOCKS}}
    hybrid, _, tokens = _disagg_topology(
        factory, "hybrid.yaml", None, True,
        make_requests=lambda seed: _mm_requests(VL2_IMAGES, seed, "ep_d"), overlay=overlay)
    gc.collect()
    torch.cuda.empty_cache()
    tie = _near_tie(factory.getLanguageModel(), factory.getTokenizer(), reqs, tokens,
                    epd_tokens, dev, vision=factory)
    hybrid["tokens_identical_to_epd"] = tokens == epd_tokens
    hybrid["divergences"] = tie
    hybrid["ok"] = bool(hybrid["ok"] and tie["ok"])
    result["ep_d"] = hybrid
    del factory
    gc.collect()
    torch.cuda.empty_cache()
    result.update(_tiny_checkpoint_check("deepseek_vl2"))
    tiny = result["tiny_checkpoint"]
    result["ok"] = bool(result["ok"] and hybrid["ok"]
                        and (not isinstance(tiny, dict) or tiny["ok"]))
    save("vl2.json", result)
    return result, counts


# -------------------------------------------------------------- phase: online

ONLINE_CONFIG = "config/serve.yaml"
ONLINE_OVERRIDES = ("cluster.node.model.name=random:llava-7b-lm",
                    "cluster.node.model.quantization=int8",
                    "cluster.node.model.kv_cache_dtype=int8")
ONLINE_BOOT_LIMIT_S = 600        # weights, budget search, graph captures
ONLINE_STOP_LIMIT_S = 60
ONLINE_LONE_PROMPT, ONLINE_LONE_TOKENS = 128, 64
ONLINE_BURST, ONLINE_BURST_TOKENS = 64, 128
ONLINE_BURST_PROMPT = (100, 400)     # prompt lengths in tokens, seeded
# the serving path's kernels (K1-K4), each of which must launch in the burst
ONLINE_KERNELS = SERVE_KERNELS


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _http(port: int, method: str, path: str, body=None, raw: bytes = None,
          timeout: float = 600.0):
    """(status, body bytes) of one request to the local server."""
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        data = raw if raw is not None else (None if body is None
                                            else json.dumps(body).encode())
        conn.request(method, path, body=data,
                     headers={"Content-Type": "application/json"} if data else {})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _metrics(port: int) -> dict:
    status, body = _http(port, "GET", "/metrics", timeout=60)
    if status != 200:
        raise RuntimeError(f"/metrics answered {status}")
    (row,) = json.loads(body).values()      # one node
    return row


def _stream_chat(port: int, prompt: str, max_tokens: int, temperature: float = 0.0,
                 image_b64: str = None) -> dict:
    """One streaming chat request (with an image_url part when image_b64 is
    given): the client-clock times of its deltas (the content chunks; the
    finish chunk is not a delta) and whether it ended in [DONE]."""
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=900)
    content = prompt if image_b64 is None else [
        {"type": "text", "text": prompt},
        {"type": "image_url", "image_url": {"url": f"data:image/png;base64,{image_b64}"}}]
    body = {"messages": [{"role": "user", "content": content}],
            "max_tokens": max_tokens, "ignore_eos": True, "stream": True,
            "temperature": temperature}
    t0 = time.perf_counter()
    times, texts, done, status = [], [], False, None
    try:
        conn.request("POST", "/v1/chat/completions", body=json.dumps(body).encode(),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        status = resp.status
        while True:
            line = resp.readline()
            if not line:
                break
            line = line.decode("utf-8", "replace").strip()
            if not line.startswith("data: "):
                continue
            data = line[len("data: "):]
            if data == "[DONE]":
                done = True
                break
            choice = json.loads(data)["choices"][0]
            if choice.get("finish_reason") is None:
                times.append(time.perf_counter() - t0)
                texts.append(choice["delta"].get("content") or "")
    finally:
        conn.close()
    return {"status": status, "done": done, "times": times, "text": "".join(texts)}


def _pct(xs, q: float) -> float:
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(q * len(xs)))]


def phase_online(dev="cuda") -> dict:
    """Online serving through the real entry point, run as a child process:
    `python -m hydrainfer_tpu_torch.entrypoint.entrypoint --config
    config/serve.yaml` with llava-7b-lm at full width (int8 weights, int8
    KV), everything else as serve.yaml has it (64 running requests, chunked
    prefill, K=8 windows, the budget search at tpot_slo 0.4, an auto-sized
    KV pool). Boot under ONLINE_BOOT_LIMIT_S; one lone /v1/completions
    request (a seeded 128-token prompt, 64 tokens); a burst of 64 streaming
    chats at once (seeded 100-400-token prompts, 128 tokens each), timed on
    the client's clock; /health, a malformed body (a 400), an idle second
    that launches no kernel, a streamed chat at temperature 0.7 (16 deltas,
    then [DONE]); SIGTERM, after which the
    child must exit 0 within ONLINE_STOP_LIMIT_S. Then the port's
    OfflineEngine, built here from the same file and overrides with the
    server's KV pool size, serves the lone prompt: its text must equal the
    server's."""
    import resource
    import signal

    import numpy as np
    import torch
    root = os.path.dirname(os.path.abspath(__file__))
    torch.cuda.empty_cache()        # the child sizes its KV pool from free memory
    port = _free_port()
    overrides = [*ONLINE_OVERRIDES, f"api_server.port={port}"]
    cmd = [sys.executable, "-m", "hydrainfer_tpu_torch.entrypoint.entrypoint",
           "--config", ONLINE_CONFIG, *overrides]
    os.makedirs(OUT_DIR, exist_ok=True)
    log_path = os.path.join(OUT_DIR, "online_server.log")
    env = dict(os.environ, HYDRAINFER_LOG_LEVEL="INFO")
    rng = np.random.default_rng(SEED)
    letters = list("abcdefghijklmnopqrstuvwxyz ")
    res = {"phase": "online", "ok": False, "gpu": gpu_name_and_limit(), "command": cmd}
    checks = {}
    with open(log_path, "w") as log:
        t0 = time.perf_counter()
        child = subprocess.Popen(cmd, cwd=root, env=env, stdout=log,
                                 stderr=subprocess.STDOUT)
        try:
            while True:
                if child.poll() is not None:
                    raise RuntimeError(f"the server exited with {child.returncode} "
                                       f"while booting (log: {log_path})")
                if time.perf_counter() - t0 > ONLINE_BOOT_LIMIT_S:
                    raise RuntimeError(f"the server did not boot within "
                                       f"{ONLINE_BOOT_LIMIT_S} s")
                try:
                    status, body = _http(port, "GET", "/health", timeout=5)
                    if status == 200:
                        break
                except OSError:
                    pass
                time.sleep(0.5)
            res["boot_s"] = time.perf_counter() - t0
            checks["health_ok"] = body == b"ok"
            boot = _metrics(port)
            res.update({k: boot.get(k) for k in (
                "token_budget", "image_budget", "profiler_fallbacks", "kv_total_blocks")})
            res["graph_keys_at_boot"] = boot.get("graph_keys", [])

            lone_prompt = "".join(rng.choice(letters, size=ONLINE_LONE_PROMPT))
            t1 = time.perf_counter()
            status, body = _http(port, "POST", "/v1/completions", {
                "prompt": lone_prompt, "max_tokens": ONLINE_LONE_TOKENS,
                "ignore_eos": True})
            res["lone_s"] = time.perf_counter() - t1
            lone_text = json.loads(body)["choices"][0]["text"] if status == 200 else None
            checks["lone_ok"] = status == 200 and bool(lone_text)

            lo, hi = ONLINE_BURST_PROMPT
            prompts = ["".join(rng.choice(letters, size=int(n)))
                       for n in rng.integers(lo, hi + 1, size=ONLINE_BURST)]
            before = _metrics(port)
            from concurrent.futures import ThreadPoolExecutor
            t1 = time.perf_counter()
            with ThreadPoolExecutor(ONLINE_BURST) as pool:
                streams = list(pool.map(
                    lambda p: _stream_chat(port, p, ONLINE_BURST_TOKENS), prompts))
            burst_s = time.perf_counter() - t1
            after = _metrics(port)
            time.sleep(1.0)
            idle = _metrics(port)
            launches = {k: n - before["launches"][k] for k, n in after["launches"].items()}
            n_deltas = [len(st["times"]) for st in streams]
            first = [st["times"][0] for st in streams if st["times"]]
            gaps = [b - a for st in streams for a, b in zip(st["times"], st["times"][1:])]
            checks["burst_ok"] = all(st["status"] == 200 and st["done"] for st in streams) \
                and all(n == ONLINE_BURST_TOKENS for n in n_deltas)
            checks["kernels_launched_in_burst"] = all(launches[k] > 0 for k in ONLINE_KERNELS)
            checks["idle_second_launches_nothing"] = idle["launches"] == after["launches"]
            res.update({
                "burst_requests": ONLINE_BURST, "burst_max_tokens": ONLINE_BURST_TOKENS,
                "burst_s": burst_s, "burst_tokens_per_s": sum(n_deltas) / burst_s,
                "p50_first_delta_s": _pct(first, 0.5), "p90_first_delta_s": _pct(first, 0.9),
                "max_first_delta_s": max(first),
                "p50_inter_delta_s": _pct(gaps, 0.5), "p90_inter_delta_s": _pct(gaps, 0.9),
                "max_inter_delta_s": max(gaps),
                "launches_in_burst": launches,
                # [T, S, MB, n_steps] of each CUDA graph captured while serving
                "graph_keys_captured_in_lone": [k for k in before.get("graph_keys", [])
                                                if k not in res["graph_keys_at_boot"]],
                "graph_keys_captured_in_burst": [k for k in after.get("graph_keys", [])
                                                 if k not in before.get("graph_keys", [])],
                "fill_keys_met_in_burst": after["fill_keys"] - before["fill_keys"]})

            status, _ = _http(port, "POST", "/v1/completions", raw=b"{not json")
            checks["malformed_json_400"] = status == 400
            sampled = _stream_chat(port, "hi", 16, temperature=0.7)
            checks["temperature_served"] = (sampled["status"] == 200 and sampled["done"]
                                            and len(sampled["times"]) == 16)
            status, body = _http(port, "GET", "/health", timeout=30)
            checks["health_ok"] = checks["health_ok"] and status == 200 and body == b"ok"

            t1 = time.perf_counter()
            reaped = resource.getrusage(resource.RUSAGE_CHILDREN)
            child.send_signal(signal.SIGTERM)
            rc = child.wait(timeout=ONLINE_STOP_LIMIT_S)
            res["stop_s"] = time.perf_counter() - t1
            # the server's CPU seconds over its whole life, boot included
            usage = resource.getrusage(resource.RUSAGE_CHILDREN)
            res["server_cpu_s"] = (usage.ru_utime - reaped.ru_utime
                                   + usage.ru_stime - reaped.ru_stime)
            checks["sigterm_exit_0"] = rc == 0
        finally:
            if child.poll() is None:
                child.kill()
                child.wait()
    checks["profiler_no_fallback"] = res["profiler_fallbacks"] == 0

    res["offline"] = _online_offline_text(dev, overrides, res["kv_total_blocks"],
                                          lone_prompt)
    checks["lone_text_equals_offline"] = res["offline"].pop("text") == lone_text
    res["checks"] = checks
    res["ok"] = all(checks.values())
    res["server_log"] = log_path
    return res


def _online_offline_text(dev, overrides, kv_blocks: int, prompt: str) -> dict:
    """The lone prompt served by the port's OfflineEngine, built in this
    process from the online phase's config file and overrides, with the
    server's KV pool size."""
    import torch
    from hydrainfer_tpu_torch.config import load_config
    from hydrainfer_tpu_torch.entrypoint.entrypoint import EntryPointConfig
    from hydrainfer_tpu_torch.entrypoint.offline import OfflineEngine
    from hydrainfer_tpu_torch.models.factory import getModelFactory
    from hydrainfer_tpu_torch.request import Request, SamplingParameters
    root = os.path.dirname(os.path.abspath(__file__))
    cfg = load_config(EntryPointConfig, os.path.join(root, ONLINE_CONFIG),
                      [*overrides, f"cluster.node.n_kv_blocks={kv_blocks}"])
    node_cfg = cfg.cluster.node
    t0 = time.perf_counter()
    engine = OfflineEngine(node_cfg, getModelFactory(node_cfg.model, torch.device(dev)),
                           node_type="EPD", device=dev)
    boot_s = time.perf_counter() - t0
    (out,) = engine.generate([Request(
        request_id="lone", prompt=prompt,
        sampling_params=SamplingParameters(max_tokens=ONLINE_LONE_TOKENS,
                                           ignore_eos=True))], timeout_s=600)
    sched = engine.node.batch_scheduler
    row = {"boot_s": boot_s, "token_budget": sched.token_budget,
           "profiler_fallbacks": engine.node.profiler_fallbacks, "text": out.text}
    del engine
    torch.cuda.empty_cache()
    return row


# ------------------------------------------------------------------- main

class _ShapeSpy:
    """A wrapper's stand-in that records each call's shape; its `launches`
    is the wrapper's own (grouped_mm counts through its module name)."""

    def __init__(self, fn, shape, seen: set):
        self.fn, self.shape, self.seen = fn, shape, seen

    def __call__(self, *args, **kw):
        self.seen.add(self.shape(args))
        return self.fn(*args, **kw)

    @property
    def launches(self):
        return self.fn.launches

    @launches.setter
    def launches(self, n):
        self.fn.launches = n


class ShardShapes:
    """Wraps the kernel wrappers the model code looks up by name at call
    time and records the shapes each sees (a graphed step's at its
    capture): K4 the weight's (K, N); K1, K2 and K6 (q heads, cache
    planes); K3 the cache planes; the grouped product its experts."""

    def __init__(self):
        from hydrainfer_tpu_torch.ops import attention, cache_ops, moe, quant
        heads = lambda a: (a[0].shape[1], a[1].shape[-2])  # noqa: E731
        probes = [(quant, "quant_matmul_int8", lambda a: tuple(a[1].shape)),
                  (attention, "mha_decode_attention", heads),
                  (attention, "paged_attention_varlen", heads),
                  (attention, "paged_attention_latent", heads),
                  (cache_ops, "write_kv_pages", lambda a: a[0].shape[-2]),
                  (moe, "grouped_mm", lambda a: a[1].shape[0])]
        self.saved = [(mod, name, getattr(mod, name)) for mod, name, _ in probes]
        self.seen = {}
        for (mod, name, shape), (_, _, fn) in zip(probes, self.saved):
            setattr(mod, name, _ShapeSpy(fn, shape, self.seen.setdefault(name, set())))

    def restore(self) -> None:
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


def _tp_round(engine, reqs, k3=None, n_steps=16) -> dict:
    """One measured round of an engine: tokens, tokens/s, launch counts
    (K3 split by KvWriteSplit where given), graph replays and the widest
    K = n_steps key's device ms a decode step."""
    import torch
    from hydrainfer_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    graphs = engine.node.fill_executor.graphs
    torch.cuda.synchronize()
    reset_launch_counts()
    if k3 is not None:
        k3.reset(graphs)
    replays0 = graphs.replays
    t0 = time.perf_counter()
    outs = engine.generate(reqs, timeout_s=600)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    counts = {**launch_counts(), **(k3.counts() if k3 is not None else {})}
    keys = [(d, n, g) for (d, n), g in graphs.graphs.items() if n == n_steps and g.graph]
    d, n, g = max(keys, key=lambda x: x[0].S)
    tokens = [o.output_token_ids for o in outs]
    return {"tokens": tokens, "tokens_per_s": sum(map(len, tokens)) / elapsed,
            "elapsed_s": elapsed, "launches": counts,
            **({"kv_writer_launches": k3.report()} if k3 is not None else {}),
            "graph_keys": len(graphs.graphs), "graph_replays": graphs.replays - replays0,
            "decode_step_device_ms": _replay_ms(g.graph, replays=5) / n,
            "decode_step_key": f"T={d.T} S={d.S}"}


def _tokens_ok(tokens, n: int, vocab: int) -> bool:
    return all(len(t) == n and all(0 <= x < vocab for x in t) for t in tokens)


def _tp_compare(name, f1, f2, dev, reqs, budget, must_run, must_not_run, shapes_want,
                layered=False, spy=None) -> tuple:
    """One model at tp 1 (f1's, run first) and at tp TP_SIZE (f2's: a model
    over f1's weights, sharded by its node): a round each on the same
    requests, both with decode graphs. The tp-2 round must launch every
    kernel of must_run and none of must_not_run, at the shard shapes
    (ShardShapes, from the node's boot on: what each wrapper saw must equal
    shapes_want), and its tokens must equal tp 1's or first differ at a near
    tie (_near_tie on f1's model); one prefill's logits at tp 2 must be as
    close to the f32 reference as tp 1's and the plain path's (_tp_logits). With a RouteSpy, the routing choices of
    one 256-token prefill at tp 2 against tp 1. Returns (result, the tp-2
    round's launch counts, the tp-1 round's tokens)."""
    import gc
    import numpy as np
    import torch
    from hydrainfer_tpu_torch.request import Request
    lm1, n_tokens = f1.getLanguageModel(), reqs[0].sampling_params.max_tokens
    n_blocks = max(256, 2 * len(reqs) * (TP_PROMPT + n_tokens) // 16)
    rounds, parts, seen = {}, {}, {}
    for tp in (1, TP_SIZE):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        shapes = ShardShapes() if tp > 1 else None
        k3 = KvWriteSplit() if tp > 1 else None
        try:
            engine = _engine(f1 if tp == 1 else f2, dev if tp == 1 else [dev] * tp,
                             len(reqs), 16, n_blocks, budget, spec_ngram_k=0)
            boot_s = time.perf_counter() - t0
            rounds[tp] = _tp_round(engine, [
                Request(request_id=f"{name}{tp}_{i}", prompt=r.prompt,
                        sampling_params=r.sampling_params) for i, r in enumerate(reqs)], k3)
        finally:
            for spy_ in (k3, shapes):
                if spy_ is not None:
                    spy_.restore()
        rounds[tp].update(boot_s=boot_s, peak_memory_bytes=torch.cuda.max_memory_allocated())
        if shapes is not None:
            seen = shapes.seen
            rounds[tp]["ranks"] = [str(d) for d in
                                   engine.node.worker.language_model.weights.group.devices]
        parts[f"tp{tp}"] = time.perf_counter() - t0
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    one, two = rounds[1], rounds[TP_SIZE]
    tie = _near_tie(lm1, f1.getTokenizer(), reqs, two["tokens"], one["tokens"], dev,
                    layered=layered)
    parts["near_tie"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    logits = _tp_logits(lm1, f2.getLanguageModel(), dev, layered)
    parts["logits"] = time.perf_counter() - t0
    routing, runs = {}, [[], []]
    if spy is not None:
        t0 = time.perf_counter()
        tokens = [int(t) for t in np.random.default_rng(SEED + 3).integers(10, 120, size=256)]
        runs = []
        with torch.no_grad():
            for lm in (f2.getLanguageModel(), lm1):
                spy.record = []
                _prefill_logits(lm, tokens, dev)
                runs.append(spy.record)         # a tp-2 layer routes once, on rank 0
        spy.record = None
        routing = _flip_report(runs, len(tokens))
        parts["routing"] = time.perf_counter() - t0
    counts, vocab = two["launches"], lm1.cfg.vocab_size
    checks = {"tokens": _tokens_ok(one["tokens"], n_tokens, vocab)
              and _tokens_ok(two["tokens"], n_tokens, vocab),
              "near_tie": tie["ok"], "logits": logits.pop("logits_ok"),
              "launched": all(counts[k] > 0 for k in must_run),
              "not_launched": all(counts[k] == 0 for k in must_not_run),
              "shard_shapes": all(seen.get(k) == set(v) for k, v in shapes_want.items()),
              "graphs_replayed": two["graph_replays"] > 0 and one["graph_replays"] > 0,
              "routing_layers_paired": len(runs[0]) == len(runs[1])}
    differ = tie["divergences"]
    as_json = lambda d: {k: sorted(list(x) if isinstance(x, tuple) else x  # noqa: E731
                                   for x in v) for k, v in d.items()}
    return ({"ok": all(checks.values()), "checks": checks,
             "requests": f"{len(reqs)} x {TP_PROMPT} x {n_tokens}",
             "tp1": {k: v for k, v in one.items() if k != "tokens"},
             f"tp{TP_SIZE}": {k: v for k, v in two.items() if k != "tokens"},
             "shard_shapes": as_json(seen), "shard_shapes_expected": as_json(shapes_want),
             "tokens_identical": one["tokens"] == two["tokens"],
             "near_tie_requests": len(differ),
             "first_flip_top2_gap": differ[0]["top2_gap"] if differ else None,
             "near_tie": tie, **logits, **routing, "parts_s": parts},
            counts, one["tokens"])


def _tp_logits(lm1, lm2, dev, layered=False) -> dict:
    """One 64-token prefill's logits at tp 1 (lm1) and at tp 2 (lm2, over
    the same weights), both bf16 through the kernels, and the plain bf16
    path's, each against the f32 plain reference (built a layer at a time
    where `layered`): how far the ranks' extra roundings (each partial
    rounded before the sum) move the logits, beside the plain path's own
    bf16 distance. Checked: tp 2's distance is at most LOGITS_RATIO times
    the larger of tp 1's and the plain path's. A wrong shard (a partial
    dropped, columns out of order) moves the logits by their own size,
    which the tokens' near-tie rule cannot tell from a tie on random
    weights."""
    import numpy as np
    import torch
    probe = [int(t) for t in np.random.default_rng(SEED + 4).integers(10, 120, size=64)]
    with torch.no_grad():
        if layered:
            _, ref32, _ = _layered_f32_logits(lm1, probe, dev)
        else:
            lm32 = _f32_lm(lm1)
            ref32 = _plain_logits(lm32, probe, dev)
            del lm32
        tp1, tp2 = _prefill_logits(lm1, probe, dev), _prefill_logits(lm2, probe, dev)
        plain = _plain_logits(lm1, probe, dev)
    err = lambda x: (x - ref32).abs().max().item()  # noqa: E731
    bound = LOGITS_RATIO * max(err(tp1), err(plain))
    return {"logits_f32_max_abs": ref32.abs().max().item(),
            "logits_tp1_vs_f32_err": err(tp1), f"logits_tp{TP_SIZE}_vs_f32_err": err(tp2),
            "logits_plain_bf16_vs_f32_err": err(plain),
            f"logits_tp{TP_SIZE}_vs_tp1_err": (tp2 - tp1).abs().max().item(),
            f"logits_tp{TP_SIZE}_bound": bound, "logits_ok": err(tp2) <= bound}


def _tp_migration(f_p, f_d, dev, reqs, ref_tokens, parallel="tp", size=TP_SIZE) -> dict:
    """A P node at tp TP_SIZE (f_p's model, sharded in part 1) hands each
    request to a D node at tp 1 (f_d's), which pulls its KV blocks (gathered
    from the P node's rank shards into the single-device layout); every
    payload must hold all the KV heads and land in the D node's blocks
    exactly, and the tokens must equal the tp-1 node's (ref_tokens) or
    first differ at a near tie. With parallel "pp", the P node is at pp
    `size` and its blocks are gathered from its stages' layer runs."""
    import asyncio
    import torch
    from hydrainfer_tpu_torch.cluster.migrate import MigrateGraphBuilder, NodeType
    from hydrainfer_tpu_torch.cluster.node import AsyncEPDNode, NodeContext
    from hydrainfer_tpu_torch.engine.output_token_processor import LogOutputTokenProcessor
    from hydrainfer_tpu_torch.engine.request_processor import RequestProcessParameters
    from hydrainfer_tpu_torch.request import Request
    n_blocks = max(256, 2 * len(reqs) * (TP_PROMPT + TP_TOKENS) // 16)
    t0 = time.perf_counter()
    nodes = []
    for name, node_type, device, factory in (("p0", "P", [dev] * size, f_p),
                                             ("d0", "D", dev, f_d)):
        node = AsyncEPDNode(_node_config(len(reqs), 16, n_blocks, TP_BUDGET, spec_ngram_k=0),
                            NodeContext(name=name, node_type=NodeType(node_type),
                                        device=device, parallel=parallel))
        node.init(factory)
        nodes.append(node)
    builder = MigrateGraphBuilder()
    for node in nodes:
        builder.add_node(node.name, node.context.node_type, node, tpot_slo=0.4)
    graph = builder.build_graph()
    for node in nodes:
        node.update_migrate_graph(graph)
    boot_s = time.perf_counter() - t0
    d_mgr, landed = nodes[1].kv_cache_manager, []
    scatter = d_mgr.scatter_blocks

    def scatter_checked(block_ids, blocks):
        scatter(block_ids, blocks)
        landed.append(blocks.shape[1:] == d_mgr.cache_array[:, :, 0].shape and torch.equal(
            d_mgr.gather_blocks(block_ids), blocks.to(d_mgr.dtype)))

    d_mgr.scatter_blocks = scatter_checked

    async def run():
        procs = [LogOutputTokenProcessor() for _ in reqs]
        for i, (r, proc) in enumerate(zip(reqs, procs)):
            await nodes[0].add_request(
                Request(request_id=f"mig{i}", prompt=r.prompt,
                        sampling_params=r.sampling_params),
                RequestProcessParameters(output_token_processors=[proc]))
        deadline = time.perf_counter() + 300
        while not all(p.finished for p in procs):
            for node in nodes:
                await node.step()
            await asyncio.sleep(0)
            if time.perf_counter() > deadline:
                raise TimeoutError(f"stalled: {[len(p.token_ids) for p in procs]}")
        return [p.token_ids for p in procs]

    t0 = time.perf_counter()
    tokens = asyncio.run(run())
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    d_metrics = nodes[1].metrics()
    p_cache = nodes[0].kv_cache_manager.cache_array
    lm_d = f_d.getLanguageModel()
    tie = _near_tie(lm_d, f_d.getTokenizer(), reqs, tokens, ref_tokens, dev)
    differ = tie["divergences"]
    checks = {"tokens": _tokens_ok(tokens, TP_TOKENS, lm_d.cfg.vocab_size),
              "near_tie": tie["ok"],
              "pulled": d_metrics.get("migration_pulls") == len(reqs),
              "payloads_landed": len(landed) == len(reqs) and all(landed),
              "p_sharded": isinstance(p_cache, list) and len(p_cache) == size}
    return {"ok": all(checks.values()), "checks": checks, "boot_s": boot_s,
            "elapsed_s": elapsed, "tokens_per_s": sum(map(len, tokens)) / elapsed,
            "tokens_identical_to_tp1": tokens == ref_tokens,
            "near_tie_requests": len(differ),
            "first_flip_top2_gap": differ[0]["top2_gap"] if differ else None,
            "near_tie": tie, "d_migration": {k: v for k, v in d_metrics.items()
                                             if k.startswith("migration_")}}


def phase_tp(dev="cuda") -> tuple:
    """Tensor and expert parallelism (parallel/mesh.py) at tp_size TP_SIZE,
    both ranks on the one card (the cluster's wrap-around rule), decode
    from CUDA graphs:
    1. llava-7b-lm (32 layers x 4096, 32 heads; int8 weights, int8 KV at
       0.05) on one PD node at tp 1 and then at tp 2 over the same seeded
       weights (the tp-2 model's row and expert slices are views of the
       tp-1 tensors, its permuted columns copies): 8 requests x 128-token
       prompts x 64 tokens. K1-K4 launch at the shard shapes (16 q / 16 kv
       heads x d128; K4 at qkv 4096 x 6144, o 2048 x 4096, gate_up 4096 x
       11008, down 5504 x 4096, lm_head 4096 x 16000), and the tokens equal
       tp 1's or first differ at a near tie;
    2. DeepSeek-V2-Lite at full width and depth (27 layers; MLA over the
       latent cache every rank holds a copy of; 32 of the 64 experts a rank)
       at tp 1 and tp 2, 8 x 128 x 32: K6, K3, K4 and the grouped product
       launch (8 heads a rank over the 576-wide plane, 32 experts), K1 and
       K2 never; the tokens under the same rule, and the routing choices of
       one 256-token prefill at tp 2 against tp 1 (routing_first_layer_*);
    3. a P node at tp 2 hands off to a D node at tp 1 on llava-7b-lm (the
       KV blocks gathered from the two rank shards): part 1's requests, whose
       tokens equal part 1's tp-1 tokens or first differ at a near tie.
    Returns (result, {"tp": part 1's tp-2 launch counts, "tp_mla": part
    2's})."""
    import gc
    import numpy as np
    import torch
    from hydrainfer_tpu_torch.models.random_init import RandomWeightFactory
    from hydrainfer_tpu_torch.request import Request, SamplingParameters
    dev = torch.device(dev)
    result, counts, parts = {"phase": "tp", "gpu": gpu_name_and_limit(),
                             "tp_size": TP_SIZE}, {}, {}
    reqs = _requests(np.random.default_rng(SEED + 9), TP_REQUESTS, TP_PROMPT, TP_TOKENS, "tp")

    # 1. llava-7b-lm at tp 1, then tp 2 over the same tensors
    t0 = time.perf_counter()
    llava = dict(dtype=torch.bfloat16, quantization="int8", kv_scale=0.05, device=dev,
                 seed=SEED)
    f1 = RandomWeightFactory("llava-7b-lm", **llava)
    f2 = RandomWeightFactory("llava-7b-lm", weights=f1.getLanguageModel().weights, **llava)
    torch.cuda.synchronize()
    parts["llava_init"] = time.perf_counter() - t0
    want = {"quant_matmul_int8": {(4096, 6144), (2048, 4096), (4096, 11008), (5504, 4096),
                                  (4096, 16032)},
            "mha_decode_attention": {(16, 32)}, "paged_attention_varlen": {(16, 32)},
            "write_kv_pages": {32}}
    t0 = time.perf_counter()
    try:
        result["llava"], counts["tp"], tp1_tokens = _tp_compare(
            "llava", f1, f2, dev, reqs, TP_BUDGET, SERVE_KERNELS, (), want)
        parts["llava"] = time.perf_counter() - t0

        # 3. P at tp 2 -> D at tp 1, on the same two models
        t0 = time.perf_counter()
        result["migration"] = _tp_migration(f2, f1, dev, reqs, tp1_tokens)
        parts["migration"] = time.perf_counter() - t0
    except Exception as e:      # a failed part fails the phase; the next still runs
        traceback.print_exc()
        result.setdefault("llava", {"ok": False, "error": repr(e)})
        result.setdefault("migration", {"ok": False, "error": repr(e)})
    del f1, f2
    gc.collect()
    torch.cuda.empty_cache()

    # 2. DeepSeek-V2-Lite at tp 1, then tp 2 over the same tensors
    t0 = time.perf_counter()
    g1 = _moe_lm_factory(dev, DEEPSEEK_V2_LITE)
    g2 = RandomWeightFactory("tiny-lm", dtype=torch.bfloat16, quantization="int8",
                             kv_scale=0.05, device=dev, seed=SEED,
                             weights=g1.getLanguageModel().weights)
    g2.cfg = g1.cfg
    torch.cuda.synchronize()
    parts["deepseek_init"] = time.perf_counter() - t0
    spy = RouteSpy(1, -1)
    want = {"paged_attention_latent": {(8, 1)}, "write_kv_pages": {1},
            "grouped_mm": {DEEPSEEK_V2_LITE["n_routed_experts"] // TP_SIZE},
            "quant_matmul_int8": {(1024, 2048), (2048, 10944), (5472, 2048), (2048, 2816),
                                  (1408, 2048), (2048, 51200)}}
    mla_reqs = [Request(request_id=r.request_id, prompt=r.prompt,
                        sampling_params=SamplingParameters(max_tokens=TP_MLA_TOKENS,
                                                           ignore_eos=True)) for r in reqs]
    t0 = time.perf_counter()
    try:
        result["deepseek"], counts["tp_mla"], _ = _tp_compare(
            "v2", g1, g2, dev, mla_reqs, TP_MLA_BUDGET, MLA_KERNELS + ("grouped_mm",),
            ("mha_decode", "paged_attention"), want, layered=True, spy=spy)
    except Exception as e:
        traceback.print_exc()
        result["deepseek"] = {"ok": False, "error": repr(e)}
    finally:
        spy.restore()
    parts["deepseek"] = time.perf_counter() - t0
    result["deepseek"]["model"] = ("DeepSeek-V2-Lite (the widths and depth of its "
                                   f"config.json) over {TP_SIZE} ranks: 8 heads and 32 "
                                   "experts a rank")
    del g1, g2
    gc.collect()
    torch.cuda.empty_cache()
    result["parts_s"] = parts
    result["ok"] = bool(all(result[k]["ok"] for k in ("llava", "migration", "deepseek")))
    save("tp.json", result)
    return result, counts


class PPFormSplit:
    """The launch counts of a pipeline-parallel round by step form
    (parallel/pipeline.py:step_form): the microbatched decode's and the
    relay's. It wraps the two schedules, which pp_step looks up by name,
    and reads the wrappers' counts around each call made outside a graph
    capture; each replay since `reset` of a node's graphs adds what its
    capture recorded, by its key's form. It also records the shapes K1 (q
    rows), K3 (rows) and K4 (M) see inside the microbatched form, at a
    graphed key's capture."""

    def __init__(self):
        import torch
        from hydrainfer_tpu_torch.ops import attention, cache_ops, quant
        from hydrainfer_tpu_torch.ops.cuda import launch_counts
        from hydrainfer_tpu_torch.parallel import pipeline
        self.form = None
        self.shapes = {"mha_decode": set(), "kv_writer": set(), "quant_matmul": set()}
        forms = {"decoder_forward_pp": "relay", "decoder_forward_pp_decode": "micro"}
        probes = [(attention, "mha_decode_attention", "mha_decode", lambda a: a[0].shape[0]),
                  (cache_ops, "write_kv_pages", "kv_writer", lambda a: a[1].shape[0]),
                  (quant, "quant_matmul_int8", "quant_matmul", lambda a: a[0].shape[0])]
        self.saved = [(pipeline, name, getattr(pipeline, name)) for name in forms]
        self.saved += [(mod, name, getattr(mod, name)) for mod, name, _, _ in probes]
        self.reset()

        def schedule(fn, form):
            def spy(*args, **kw):
                before, self.form = launch_counts(), form
                try:
                    return fn(*args, **kw)
                finally:
                    self.form = None
                    if not torch.cuda.is_current_stream_capturing():
                        for k, n in launch_counts().items():
                            self.eager[form][k] = self.eager[form].get(k, 0) + n - before[k]
            return spy

        def probe(fn, key, rows):
            def spy(*args, **kw):
                if self.form == "micro":
                    self.shapes[key].add(rows(args))
                return fn(*args, **kw)
            return spy

        for name, form in forms.items():
            setattr(pipeline, name, schedule(getattr(pipeline, name), form))
        for mod, name, key, rows in probes:
            setattr(mod, name, probe(getattr(mod, name), key, rows))

    def reset(self, graphs=None) -> None:
        self.eager = {"relay": {}, "micro": {}}
        self.graphs = graphs
        self.replays0 = ({key: g.replays for key, g in graphs.graphs.items()}
                         if graphs is not None else {})

    def restore(self) -> None:
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)

    def counts(self) -> dict:
        """{form: {kernel: launches}} of the round since `reset`."""
        from hydrainfer_tpu_torch.parallel.pipeline import step_form
        out = {form: dict(c) for form, c in self.eager.items()}
        for (dims, n_steps), g in (self.graphs.graphs.items() if self.graphs else ()):
            form = step_form(dims, PP_SIZE)
            for k, n in g.launches.items():
                out[form][k] = out[form].get(k, 0) + n * (
                    g.replays - self.replays0.get((dims, n_steps), 0))
        return out


def _pp_round(engine, reqs, k3=None, split=None) -> dict:
    """One round of an engine (_tp_round's record), with a pipeline-parallel
    node's steps by form and, with a PPFormSplit, its launches by form."""
    import torch
    lm = engine.node.worker.language_model
    steps0 = dict(lm.stages.steps) if lm.stages is not None else None
    if split is not None:
        torch.cuda.synchronize()
        split.reset(engine.node.fill_executor.graphs)
    graphs = engine.node.fill_executor.graphs
    replays0, captures0 = graphs.replays, graphs.captures
    rec = _tp_round(engine, reqs, k3, n_steps=1)
    rec["graph_keys_captured_in_round"] = graphs.captures - captures0
    if steps0 is not None:
        rec["steps"] = {k: lm.stages.steps[k] - steps0[k] for k in steps0}
    if split is not None:
        rec["launches_by_form"] = split.counts()
    rec["graph_replays"] = graphs.replays - replays0
    return rec


def _pp_step_ms(lm1, cache1, lm2, engine2) -> dict:
    """A pure decode step of pp 2's round (its widest captured decode key's
    inputs, S rows) timed from CUDA graphs three ways on the same batch:
    pp 1's one-device step, and pp 2's relay and microbatched forms (each
    into a scratch token table; the cache slots are the step's own); beside
    the replays of the captured keys of that S (pp 2's microbatched, pp 1's
    K = 1)."""
    import torch
    from hydrainfer_tpu_torch.models.decoder import decoder_forward
    from hydrainfer_tpu_torch.models.factory import unpack_fill_batch
    from hydrainfer_tpu_torch.parallel import pipeline
    graphs2 = engine2.node.fill_executor.graphs
    dims, g2 = max(((d, g) for (d, n), g in graphs2.graphs.items()
                    if g.graph is not None and pipeline.step_form(d, PP_SIZE) == "micro"),
                   key=lambda x: x[0].S)
    batch = unpack_fill_batch(g2.flat, dims, None, lm2.cfg.hidden_size)
    caches2 = engine2.node.kv_cache_manager.cache_array
    table = torch.zeros_like(engine2.node.fill_executor.token_table)
    forms = {
        "pp1_step_ms": lambda: decoder_forward(lm1.weights, cache1, batch, lm1.cos_tab,
                                               lm1.sin_tab, lm1.cfg, 1, table),
        "relay_step_ms": lambda: pipeline.decoder_forward_pp(
            lm2.stages, caches2, batch, lm2.cos_tab, lm2.sin_tab, 1, table),
        "micro_step_ms": lambda: pipeline.decoder_forward_pp_decode(
            lm2.stages, caches2, batch, lm2.cos_tab, lm2.sin_tab, table, PP_SIZE)}
    out = {"step_key": f"T={dims.T} S={dims.S} MB={dims.MB}"}
    for name, fn in forms.items():
        out[name] = graph_ms(fn, calls=10, replays=3)
    out["micro_key_replay_ms"] = _replay_ms(g2.graph, replays=10)
    return out


def _pp_compare(name, f1, f2, dev, reqs, budget, must_run, node_type="PD",
                n_blocks=None, n_image_blocks=-1, vision=None, step_ms=False) -> tuple:
    """One model at pp 1 (f1's, K = 1 windows, first) and at pp PP_SIZE
    (f2's: a model over f1's tensors, staged by its node), a round each on
    the same requests, decode from CUDA graphs (pp 2's keys captured at
    their first meeting: a pipeline-parallel node runs no boot warm-up).
    The pp-2 round must run both step forms and launch every kernel of
    must_run, and its tokens must equal pp 1's or first differ at a near
    tie (_near_tie on f1's model; `vision`, the factory of image
    requests). With step_ms, _pp_step_ms. Returns (result, the pp-2
    round's launch counts, the pp-1 round's tokens)."""
    import gc
    import torch
    from hydrainfer_tpu_torch.request import Request
    lm1, n_tokens = f1.getLanguageModel(), reqs[0].sampling_params.max_tokens
    n_blocks = n_blocks or max(256, 2 * len(reqs) * (TP_PROMPT + n_tokens) // 16)
    rounds, parts, engines = {}, {}, {}
    for pp in (1, PP_SIZE):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        k3 = KvWriteSplit() if pp > 1 else None
        split = PPFormSplit() if pp > 1 else None
        try:
            engine = _engine(f1 if pp == 1 else f2, dev if pp == 1 else [dev] * pp,
                             len(reqs), 16, n_blocks, budget, node_type=node_type,
                             n_image_blocks=n_image_blocks, spec_ngram_k=0,
                             multi_step_decode=1, parallel="pp")
            boot_s = time.perf_counter() - t0
            rounds[pp] = _pp_round(engine, [
                Request(request_id=f"{name}{pp}_{i}", prompt=r.prompt, image=r.image,
                        sampling_params=r.sampling_params) for i, r in enumerate(reqs)],
                k3, split)
            if split is not None:
                rounds[pp]["micro_shapes"] = {k: sorted(v) for k, v in split.shapes.items()}
        finally:
            for spy_ in (k3, split):
                if spy_ is not None:
                    spy_.restore()
        rounds[pp].update(boot_s=boot_s, peak_memory_bytes=torch.cuda.max_memory_allocated())
        engines[pp] = engine
        parts[f"pp{pp}"] = time.perf_counter() - t0
    lm2 = engines[PP_SIZE].node.worker.language_model
    two = rounds[PP_SIZE]
    two["stages"] = [{"device": str(st.device), "layers": [st.first, st.first + st.n_layers - 1]}
                     for st in lm2.stages.stages]
    if step_ms:
        t0 = time.perf_counter()
        two["step_ms"] = _pp_step_ms(lm1, engines[1].node.kv_cache_manager.cache_array, lm2,
                                     engines[PP_SIZE])
        two["step_ms"]["pp1_key_replay_ms"] = rounds[1]["decode_step_device_ms"]
        parts["step_ms"] = time.perf_counter() - t0
    del engines, engine
    gc.collect()
    torch.cuda.empty_cache()
    one = rounds[1]
    t0 = time.perf_counter()
    tie = _near_tie(lm1, f1.getTokenizer(), reqs, two["tokens"], one["tokens"], dev,
                    vision=vision)
    parts["near_tie"] = time.perf_counter() - t0
    counts, vocab = two["launches"], lm1.cfg.vocab_size
    micro = two["micro_shapes"]
    checks = {"tokens": _tokens_ok(one["tokens"], n_tokens, vocab)
              and _tokens_ok(two["tokens"], n_tokens, vocab),
              "near_tie": tie["ok"],
              "both_forms_ran": two["steps"]["relay"] > 0 and two["steps"]["micro"] > 0,
              "launched": all(counts[k] > 0 for k in must_run),
              "micro_launched": all(two["launches_by_form"]["micro"].get(k, 0) > 0
                                    for k in ("mha_decode", "kv_writer", "quant_matmul")),
              "micro_shapes": all(len(reqs) // PP_SIZE in micro[k]
                                  for k in ("mha_decode", "kv_writer", "quant_matmul")),
              "graphs_replayed": two["graph_replays"] > 0 and one["graph_replays"] > 0}
    differ = tie["divergences"]
    return ({"ok": all(checks.values()), "checks": checks,
             "pp1": {k: v for k, v in one.items() if k != "tokens"},
             f"pp{PP_SIZE}": {k: v for k, v in two.items() if k != "tokens"},
             "tokens_identical": one["tokens"] == two["tokens"],
             "near_tie_requests": len(differ),
             "first_flip_top2_gap": differ[0]["top2_gap"] if differ else None,
             "near_tie": tie, "parts_s": parts},
            counts, one["tokens"])


def phase_pp(dev="cuda") -> tuple:
    """Pipeline parallelism (parallel/pipeline.py) at pp_size PP_SIZE, both
    stages on the one card (the cluster's wrap-around rule), decode from
    CUDA graphs; on one card it tests function, not speed:
    1. llava-7b-lm (32 layers x 4096; int8 weights, int8 KV at 0.05) on one
       PD node at pp 1 (K = 1 windows) and then at pp 2 over the same seeded
       tensors (stage 0 layers 0-15, stage 1 16-31): 8 requests x 128-token
       prompts x 64 tokens, budget 256. Both step forms run (the relay for
       prefill and mixed steps, the microbatched decode for pure decode
       steps: 2 microbatches of 4 sequences), K1-K4 launch (inside the
       microbatched form K1 over 4 sequences, K4 at M 4), the tokens equal
       pp 1's or first differ at a near tie, and one decode step is timed
       from graphs at pp 1 and in both forms at pp 2 (_pp_step_ms);
    2. Qwen2-VL-2B's EPD node (bf16 ViT through K5, int8 LM, M-RoPE; 14 of
       28 layers a stage) on the vlm phase's 8 images x 32 tokens at pp 1
       and pp 2, under the same rule;
    3. a P node at pp 2 hands off to a D node at pp 1 on llava-7b-lm (the KV
       blocks gathered from the two stages' layer runs): part 1's
       requests, whose tokens equal part 1's pp-1 tokens or first differ
       at a near tie.
    Returns (result, {"pp": part 1's pp-2 launch counts})."""
    import gc
    from dataclasses import replace
    import numpy as np
    import torch
    from hydrainfer_tpu_torch.models.random_init import RandomWeightFactory
    dev = torch.device(dev)
    result, counts, parts = {"phase": "pp", "gpu": gpu_name_and_limit(),
                             "pp_size": PP_SIZE}, {}, {}
    reqs = _requests(np.random.default_rng(SEED + 10), TP_REQUESTS, TP_PROMPT, TP_TOKENS,
                     "pp")

    # 1. llava-7b-lm at pp 1, then pp 2 over the same tensors
    t0 = time.perf_counter()
    llava = dict(dtype=torch.bfloat16, quantization="int8", kv_scale=0.05, device=dev,
                 seed=SEED)
    f1 = RandomWeightFactory("llava-7b-lm", **llava)
    f2 = RandomWeightFactory("llava-7b-lm", weights=f1.getLanguageModel().weights, **llava)
    torch.cuda.synchronize()
    parts["llava_init"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    try:
        result["llava"], counts["pp"], pp1_tokens = _pp_compare(
            "llava", f1, f2, dev, reqs, TP_BUDGET, SERVE_KERNELS, step_ms=True)
        parts["llava"] = time.perf_counter() - t0

        # 3. P at pp 2 -> D at pp 1, on the same two models
        t0 = time.perf_counter()
        result["migration"] = _tp_migration(f2, f1, dev, reqs, pp1_tokens, parallel="pp",
                                            size=PP_SIZE)
        parts["migration"] = time.perf_counter() - t0
    except Exception as e:      # a failed part fails the phase; the next still runs
        traceback.print_exc()
        result.setdefault("llava", {"ok": False, "error": repr(e)})
        result.setdefault("migration", {"ok": False, "error": repr(e)})
    del f1, f2
    gc.collect()
    torch.cuda.empty_cache()

    # 2. Qwen2-VL-2B's EPD node at pp 1, then pp 2 over the same tensors
    t0 = time.perf_counter()
    try:
        v1 = _qwen2vl_factory(dev)
        lm2 = RandomWeightFactory(VLM_ARCH, dtype=torch.bfloat16, quantization="int8",
                                  kv_scale=0.05, device=dev, seed=SEED,
                                  weights=v1.getLanguageModel().weights)
        lm2.cfg = replace(lm2.cfg, mrope_section=VLM_MROPE)
        v2 = _mm_factory(lm2, v1.getVisionModel(), v1.getVisionModelConfig(),
                         v1.getProcessor())
        parts["vlm_init"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        vreqs = _vlm_requests(np.random.default_rng(SEED + 11), PP_VLM_TOKENS, "ppv")
        result["vlm"], _, _ = _pp_compare("vlm", v1, v2, dev, vreqs, 2048, VLM_KERNELS,
                                          node_type="EPD", n_blocks=512, n_image_blocks=64,
                                          vision=v1)
        result["vlm"]["model"] = ("Qwen2-VL-2B: ViT {depth} x {embed_dim}, {num_heads} "
                                  "heads; LM ".format(**VLM_VISION) + VLM_ARCH)
        del v1, v2, lm2
    except Exception as e:
        traceback.print_exc()
        result["vlm"] = {"ok": False, "error": repr(e)}
    parts["vlm"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    result["parts_s"] = parts
    result["ok"] = bool(all(result[k]["ok"] for k in ("llava", "migration", "vlm")))
    save("pp.json", result)
    return result, counts


# the drivers phase: interference's and ab_bench's traffic (batch x prompt x
# generated tokens), the A/B's variants and rounds, spec_bench's batch
DRIVERS_BATCH, DRIVERS_PROMPT, DRIVERS_GEN = 8, 128, 16
DRIVERS_AB = ("int8;quant=int8;kv_int8=1", "fp8;quant=fp8;kv_int8=1")
DRIVERS_AB_ROUNDS = 2
DRIVERS_SPEC_BATCH, DRIVERS_SPEC_TOKENS = 2, 48
DRIVERS_PACK_REPEATS = 5
# the kernels each driver must launch: Qwen2-VL's LM and tower, the A/B's
# int8 and fp8 forms, the spec A/B over the int8 weights
DRIVERS_KERNELS = {"interference": VLM_KERNELS,
                   "ab_bench": SERVE_KERNELS + ("quant_matmul_fp8",),
                   "spec_bench": SERVE_KERNELS}


class PackTimer:
    """Times each fill plan's packing while installed: after the engine's
    own build() of a contiguous batch, the native packer and the Python
    packer each pack the same plan DRIVERS_PACK_REPEATS times on the host's
    clock, and the two buffers are compared bit for bit."""

    def __init__(self):
        self.rows = []

    def __enter__(self):
        import numpy as np
        from hydrainfer_tpu_torch.engine import params_builder
        self.cls = params_builder.LanguageModelBatchBuilder
        self.orig = self.cls.build
        timer = self

        def build(builder, *a, **k):
            plan = timer.orig(builder, *a, **k)
            if builder._contiguous:
                d, times = plan.dims, {}
                for name, fn in (("native", builder._build_native),
                                 ("python", builder._build_python)):
                    t0 = time.perf_counter()
                    for _ in range(DRIVERS_PACK_REPEATS):
                        out = fn(d)
                    times[name] = (time.perf_counter() - t0) / DRIVERS_PACK_REPEATS
                    times[name + "_flat"] = out
                timer.rows.append({
                    "form": "decode" if d.max_q == 1 else "prefill", "T": d.T, "S": d.S,
                    "MB": d.MB, "native_us": 1e6 * times["native"],
                    "python_us": 1e6 * times["python"],
                    "equal": bool(np.array_equal(times["native_flat"],
                                                 times["python_flat"]))})
            return plan
        self.cls.build = build
        return self

    def __exit__(self, *exc):
        self.cls.build = self.orig

    def report(self) -> dict:
        out = {}
        for form in ("decode", "prefill"):
            rows = [r for r in self.rows if r["form"] == form]
            if rows:
                out[form] = {"plans": len(rows),
                             "shapes": sorted({(r["T"], r["S"], r["MB"]) for r in rows}),
                             "native_us": sum(r["native_us"] for r in rows) / len(rows),
                             "python_us": sum(r["python_us"] for r in rows) / len(rows)}
        out["all_equal"] = bool(self.rows) and all(r["equal"] for r in self.rows)
        return out


def _driver_launches(name, counts) -> dict:
    want = DRIVERS_KERNELS[name]
    return {"launches": {k: counts[k] for k in want},
            "launched": all(counts[k] > 0 for k in want)}


def phase_drivers(dev="cuda") -> dict:
    """The drivers phase (see the module docstring). Every driver runs on
    the card through its own public function, with the kernel launch counts
    zeroed before it and read after it."""
    import numpy as np
    import torch
    from hydrainfer_tpu_torch.engine import hostops
    from hydrainfer_tpu_torch.evaluation import ab_bench, interference, spec_bench
    from hydrainfer_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    result, parts, checks = {"phase": "drivers", "gpu": gpu_name_and_limit()}, {}, {}

    # the packer: built by the first engine of this process, or here
    t0 = time.perf_counter()
    try:
        lib = hostops.load().__file__
        result["packer"] = {"built": True, "build_s": hostops.build_seconds,
                            "library": os.path.basename(lib)}
    except Exception as e:
        traceback.print_exc()
        result["packer"] = {"built": False, "error": repr(e)}
    checks["packer_built"] = result["packer"]["built"]
    parts["packer_build"] = time.perf_counter() - t0

    # 1. interference on Qwen2-VL-2B
    t0 = time.perf_counter()
    try:
        vlm = _qwen2vl_factory(dev)
        reset_launch_counts()
        r = interference.run_analysis(VLM_ARCH, batch=DRIVERS_BATCH,
                                      prompt_len=DRIVERS_PROMPT, gen=DRIVERS_GEN,
                                      device=dev, factories=(vlm.lm_factory, vlm))
        r.update(_driver_launches("interference", launch_counts()))
        r["markdown"] = interference.to_markdown(r)
        result["interference"] = r
        checks["interference_launched"] = r["launched"]
        checks["interference_finished"] = all(
            s["tokens_per_s"] > 0 for s in r["stages"].values())
        del vlm
    except Exception as e:
        traceback.print_exc()
        result["interference"] = {"ok": False, "error": repr(e)}
        checks["interference_finished"] = False
    parts["interference"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()

    # 2. ab_bench on llava-7b-lm; run_ab asserts that every request of every
    # round finishes with its tokens
    t0 = time.perf_counter()
    engines = []
    try:
        reset_launch_counts()
        r = ab_bench.run_ab("llava-7b-lm", DRIVERS_AB, rounds=DRIVERS_AB_ROUNDS,
                            n_requests=DRIVERS_BATCH, prompt_len=DRIVERS_PROMPT,
                            max_tokens=DRIVERS_GEN, device=dev, log=lambda s: None,
                            keep=engines)
        r.update(_driver_launches("ab_bench", launch_counts()))
        result["ab_bench"] = r
        checks["ab_finished"] = sorted(r["variants"]) == sorted(
            v.split(";")[0] for v in DRIVERS_AB)
        checks["ab_launched"] = r["launched"]
    except Exception as e:
        traceback.print_exc()
        result["ab_bench"] = {"ok": False, "error": repr(e)}
        checks["ab_finished"] = False
    parts["ab_bench"] = time.perf_counter() - t0

    # 3. spec_bench over the A/B's int8 weights; then the packer's timing round
    t0 = time.perf_counter()
    try:
        factory = engines[0].node.model_factory
        del engines[1:]
        gc.collect()
        torch.cuda.empty_cache()
        reset_launch_counts()
        keep = {}
        r = spec_bench.run_spec_bench("llava-7b-lm", batch=DRIVERS_SPEC_BATCH,
                                      max_tokens=DRIVERS_SPEC_TOKENS, rounds=1, device=dev,
                                      factory=factory, log=lambda s: None, keep=keep)
        r.update(_driver_launches("spec_bench", launch_counts()))
        (base, spec), = keep["outs"]
        reqs = spec_bench.make_requests(DRIVERS_SPEC_BATCH, spec_bench.PROMPT,
                                        DRIVERS_SPEC_TOKENS, "s0")
        r["near_tie"] = _near_tie(factory.getLanguageModel(), keep["spec"].tokenizer, reqs,
                                  [o.output_token_ids for o in spec],
                                  [o.output_token_ids for o in base], dev)
        result["spec_bench"] = r
        checks["spec_tokens"] = r["near_tie"]["ok"]
        checks["spec_finished"] = all(len(o.output_token_ids) == DRIVERS_SPEC_TOKENS
                                      for o in base + spec)
        checks["spec_launched"] = r["launched"]
        del keep
        parts["spec_bench"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        n_blocks = 2 * DRIVERS_BATCH * (DRIVERS_PROMPT + DRIVERS_GEN) // 16
        engine = _engine(factory, dev, DRIVERS_BATCH, 16, n_blocks, 256)
        with PackTimer() as timer:
            outs = engine.generate(_requests(np.random.default_rng(SEED + 12), DRIVERS_BATCH,
                                             DRIVERS_PROMPT, DRIVERS_GEN, "pack"))
        result["packer"]["timing"] = timer.report()
        checks["packer_equal"] = result["packer"]["timing"]["all_equal"]
        checks["packer_both_forms"] = {"decode", "prefill"} <= set(
            result["packer"]["timing"])
        checks["packer_round_finished"] = all(len(o.output_token_ids) == DRIVERS_GEN
                                              for o in outs)
        del engine
        parts["packer_round"] = time.perf_counter() - t0
    except Exception as e:
        traceback.print_exc()
        result.setdefault("spec_bench", {"ok": False, "error": repr(e)})
        checks["spec_or_packer_round"] = False
    del engines
    gc.collect()
    torch.cuda.empty_cache()
    result["parts_s"] = parts
    result["checks"] = checks
    result["ok"] = bool(checks) and all(checks.values())
    save("drivers.json", result)
    return result


def gpu_name_and_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except Exception as e:              # nvidia-smi absent: say so
        return f"nvidia-smi unavailable ({e})"


def _why(res, path="") -> list:
    """Where a phase's result failed: its error, every check that is False
    and every part whose "ok" is False, by path (the stderr summary)."""
    out = []
    if isinstance(res, dict):
        if "error" in res:
            out.append(f"{path or 'phase'}: {res['error']}")
        for k, v in res.items():
            at = f"{path}.{k}" if path else str(k)
            if v is False and (k == "ok" or path.endswith("checks")):
                out.append(at if k != "ok" else path or "ok")
            elif isinstance(v, (dict, list)):
                out.extend(_why(v, at))
    elif isinstance(res, list):
        for i, v in enumerate(res):
            out.extend(_why(v, f"{path}[{i}]"))
    return out


def main() -> int:
    global OUT_DIR
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases",
                    default="build,kernels,tiny,serve,quant,quality,spec,sample,vlm,llava,"
                            "disagg,process,"
                            "llavanext,internvl,mla,deepseek,vl2,mixtral,gpt2,tp,pp,drivers,online")
    ap.add_argument("--out-dir", default=OUT_DIR,
                    help="where the detail files go")
    args = ap.parse_args()
    OUT_DIR = args.out_dir
    phases = args.phases.split(",")
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        import hydrainfer_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port package is missing ({e})", file=sys.stderr)
        return 3
    os.environ.setdefault("HYDRAINFER_LOG_LEVEL", "WARNING")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    failed, kernel_rows, counts = [], [], {"serve": {}, "spec": {}, "vlm": {}, "llava": {},
                                           "next13b": {}, "internvl": {}, "mla": {},
                                           "deepseek": {}, "vl2": {}, "mixtral": {},
                                           "gpt2": {}, "quant_int4": {}, "quant_fp8": {},
                                           "quality": {}, "tp": {}, "tp_mla": {}, "pp": {}}
    process_counts = None       # the process phase's, summed over its node processes
    why = {}                    # a failed phase: what failed in it
    for phase in phases:
        # a finished phase's model may sit in reference cycles (engines,
        # nodes and factories point at each other): free it before the next
        # phase sizes pools and reads its peak memory
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        try:
            if phase == "build":
                res = phase_build()
            elif phase == "kernels":
                res, kernel_rows = phase_kernels()
            elif phase == "tiny":
                res = phase_tiny()
            elif phase == "serve":
                # the int8 decode step beside the quant phase's int4 and fp8;
                # the graphs-off round unprofiled: the profiler's bookkeeping
                # of an eager round costs tens of seconds of the time limit
                res, counts["serve"] = phase_serve(
                    extra_fn=lambda engine, graphs, lm: _decode_step(graphs, lm, "int8"),
                    eager_profile=False)
            elif phase == "quant":
                res, by_mode = phase_quant()
                counts.update({f"quant_{m}": c for m, c in by_mode.items()})
            elif phase == "quality":
                res, counts["quality"], quality_rows = phase_quality()
                kernel_rows = kernel_rows + quality_rows
            elif phase == "spec":
                res, counts["spec"] = phase_spec()
            elif phase == "sample":
                res, _ = phase_sample()
            elif phase == "vlm":
                res, counts["vlm"] = phase_vlm()
            elif phase == "llava":
                res, counts["llava"] = phase_llava()
            elif phase == "disagg":
                res = phase_disagg()
            elif phase == "process":
                res = phase_process()
                process_counts = res["general"]["launches"]
            elif phase == "llavanext":
                res, counts["next13b"] = phase_llavanext()
            elif phase == "internvl":
                res, counts["internvl"] = phase_internvl()
            elif phase == "mla":
                res, counts["mla"] = phase_mla()
            elif phase == "deepseek":
                res, counts["deepseek"] = phase_deepseek()
            elif phase == "vl2":
                res, counts["vl2"] = phase_vl2()
            elif phase == "mixtral":
                res, counts["mixtral"] = phase_mixtral()
            elif phase == "gpt2":
                res, counts["gpt2"] = phase_gpt2()
            elif phase == "tp":
                res, tp_counts = phase_tp()
                counts.update(tp_counts)
            elif phase == "pp":
                res, pp_counts = phase_pp()
                counts.update(pp_counts)
            elif phase == "drivers":
                res = phase_drivers()
            elif phase == "online":
                res = phase_online()
            else:
                raise ValueError(f"unknown phase {phase}")
        except Exception as e:
            traceback.print_exc()
            res = {"phase": phase, "ok": False, "error": repr(e)}
        res["phase_s"] = time.perf_counter() - t0
        if phase in ("spec", "sample") and "sample" not in phases[phases.index(phase) + 1:]:
            _LLAVA.clear()          # the last phase on the shared llava-7b-lm weights
        if not {"disagg", "process"} & set(phases[phases.index(phase) + 1:]):
            _LLAVA_MM.clear()       # no later phase serves the llava phase's factory
        emit(res)
        save(f"phase_{phase}.json", res)        # whole, where stdout's tail may not be
        if not res["ok"]:
            failed.append(phase)
            why[phase] = _why(res)[:20]

    print(gpu_name_and_limit(), flush=True)
    kernels = []
    for r in kernel_rows:
        source, replaces = KERNEL_SOURCES[r["name"]]
        # one row per kernel and path (K3: per path and form): timed at that
        # path's shapes, launches from that path's measured round
        kernels.append({"name": r["name"], "route": "cuda", "source": source,
                        "replaces": replaces, "path": r["path"],
                        **({"form": r["form"]} if "form" in r else {}),
                        "launches": counts[r["path"]].get(_launch_key(r), 0),
                        # the llava-7b rows: the kernel's launches (K3: both
                        # forms) in the process phase's measured round
                        **({"process_launches": process_counts.get(r["name"], 0)}
                           if process_counts is not None and r["path"] in ("serve", "llava")
                           else {}),
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                        **({"library": r["library"]} if r.get("library") else {}),
                        **{k: r[k] for k in ("graph_ms", "library_graph_ms",
                                             "bit_exact_vs_host", "graph_replays_equal",
                                             "mixed_ms",
                                             "mixed_graph_ms", "mixed_bound_ms",
                                             "mixed_library_ms", "mixed_library_graph_ms",
                                             "drain_16_of_32",
                                             "prefill_ms", "prefill_graph_ms",
                                             "prefill_bound_ms", "prefill_library_ms",
                                             "prefill_library_graph_ms", "lm_head_n",
                                             "lm_head_ms", "lm_head_graph_ms",
                                             "lm_head_bound_ms", "lm_head_library_ms",
                                             "lm_head_library_graph_ms")
                           if k in r},
                        "shape": r["shape"], "ok": r["ok"]})
    emit({"kernels": kernels})
    if failed:
        for phase in failed:
            print(f"chip_smoke: {phase} failed at: {why[phase]}", file=sys.stderr)
        print(f"chip_smoke: failed phases: {failed}", file=sys.stderr)
        return 1
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
