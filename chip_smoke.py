#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``flexflow_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase, as the check runs it
    python3 chip_smoke.py --only build,kernels --reps 5
    python3 chip_smoke.py --only card,build,spec
    python3 chip_smoke.py --only card,build,kernels,spec,mixtral
    python3 chip_smoke.py --only card,build,variants
    python3 chip_smoke.py --only card,build,mixtral
    python3 chip_smoke.py --only card,build,offload
    python3 chip_smoke.py --only card,build,lora
    python3 chip_smoke.py --only card,build,serve,openai
    python3 chip_smoke.py --only card,build,finetune,train
    python3 chip_smoke.py --only card,build,graph
    python3 chip_smoke.py --only card,build,search
    python3 chip_smoke.py --only card,build,meshtrain
    python3 chip_smoke.py --only card,build,layouts
    python3 chip_smoke.py --only card,build,pp
    python3 chip_smoke.py --only card,build,pptrain
    python3 chip_smoke.py --only card,build,kernels,cp
    python3 chip_smoke.py --only card,build,dist
    python3 chip_smoke.py --only card,build,kernels --parent DIR   # beside an earlier kernel
    python3 chip_smoke.py --only card,build,variants --parent DIR  # split-K variants vs earlier

Phases, in order; any failure exits non-zero:

1. card     — needs CUDA; prints ``nvidia-smi``'s name and power limit;
              TF32 off for float32 matmuls and convolutions.
2. build    — builds the CUDA kernels from ``flexflow_tpu_torch/csrc`` with
              nvcc (``ops/kernels/_build.py``) and prints the build time.
3. kernels  — each kernel against its plain PyTorch version at LLaMA-2-7B
              shapes, with the tolerance stated beside each check; quant-matmul
              rows (qmm_int8 and qmm_int4) must be bitwise independent of the
              row count, and qmm_int4's one-hot rows must give back the
              dequantized weight (identity probe) in every regime. wgu also runs
              at each regime's edge rows (16, 17, 128, 129, the prefill
              threshold - 1 and the threshold), and the tiled and two-pass
              prefills side by side around the threshold; each timed qmm row
              logs its regime. Times each kernel, its plain version and one
              PyTorch library call (device time: CUDA events around calls
              queued while the device waits), and computes the kernel's bound
              from this run's shapes; flash_prefill is timed at the 7B shape,
              at the served prefills' shapes (the verifier's 32 heads and
              the draft's 6 at the served prompts' lengths) and with every
              row full, SDPA-causal's own work; decode_attention at the
              7B shape, the served decode's lengths, one 4096-position
              request and the verify's tree (at LLaMA-2-7B's heads, at
              Mixtral's GQA, and the 19-slot merged tree of two drafts with
              irregular parents and padding slots; every checked node
              bitwise equal to the one-token call), each rotating through
              caches past the L2. decode_attention's shard form (context
              parallelism) and merge_states on C = 1, 2 and 4 slices of one
              cache (``SHARD_DEGREES``) at LLaMA-2-7B's heads and Mixtral's
              GQA over ``SHARD_LENS`` (slots on shard boundaries, shards
              without a position) and the verify's 13-node tree: within the
              K5 limit of their plain versions, bitwise the one-device kernel
              at C = 1, within one bf16 ulp of it at C = 2 and 4; seq rank
              0's shard call and the merge timed apart. The quant-matmul rows include INT4 at the
              merged verify's 152 rows and the Mixtral expert stacks at the
              speculative verify's 104. ``--parent DIR`` builds each of an earlier
              checkout's quant_matmul.cu, flash_prefill.cu and
              decode_attention.cu that exists beside this one and times it
              beside each of its rows; every INT8 qmm output must equal it
              bitwise, and the earlier flash_prefill and decode_attention
              are held to the same limits against the plain versions as
              this tree's.
4. variants — the quant-kernel tuning path
              (``flexflow_tpu_torch.benchmarks.tune_int4_variants.run``) at
              D=4096, F=11008, B=8, group 128: the six dequant-matmul design
              variants at each of its column widths, and qmm_int8 / qmm_int4;
              every case must pass. Then each variant at each width against
              its plain version (1% of the output's magnitude) and by its
              identity probe (one-hot rows of x return the dequantized
              weight's rows, rounded to bf16, bitwise), and the plain version
              and one PyTorch library call timed beside it. The split-K
              variants (i8_group, i4_and_2dot) must give the same bits on a
              second call, and log their split of the contraction. With
              ``--parent DIR`` an earlier checkout's qmm_variants.cu is built
              too: its i8_group and i4_and_2dot are held to the same 1% of
              the plain versions and timed beside this tree's in turns
              (earlier, new, new, earlier) at every width.
5. crosscheck — a 2-layer decoder at full 7B width, INT8 and INT4: prefill
              and ``CROSSCHECK_STEPS`` = 2 decode steps through the kernels on the GPU against the
              plain versions on the CPU (same weights, same tokens). At INT8,
              ``utils/debug_dump.forward_with_traces`` on the card gives
              ``decoder.forward``'s logits bitwise (the same kernels).
6. serve    — LLaMA-2-7B INT8 (32 layers, random weights from seed 0):
              InferenceEngine + RequestManager(decode_horizon=16, pipelined)
              serve 8 requests; every request must finish and every kernel's
              launch count must rise. Every greedy decode step is a replay of
              the engine's captured CUDA graph (replays must equal the served
              steps). Then one 16-step horizon, replayed, must give the
              uncaptured body's tokens and cache bitwise from the same state.
              Prints decode tok/s, mean TTFT, peak memory, graphs captured,
              capture ms and replays beside the card's name and power limit.
7. openai   — the serving surface: the serve phase's model and manager (built
              the same way when serve is not selected) behind
              ``LLM.start_server()`` (a ``LLM`` over that manager and an
              id-level stand-in tokenizer, "17 402 9" <-> [17, 402, 9]) and
              the port's OpenAI handler on a loopback ThreadingHTTPServer.
              One sampled request (temperature 0.8, top_p 0.95, 8 tokens)
              first; then 8 client threads POST the served prompts as token
              ids to /v1/completions (greedy, 64 tokens): each answer's tokens
              must equal the serve run's, usage must count 64, every greedy
              step must be a replay (so the sampled request's slot returned to
              the replay path) and qmm_int8, decode_attention and
              flash_prefill must launch. Then the longest prompt streamed: the
              deltas must join to its completion text and end with "stop" and
              [DONE]; a 1024-token prompt and bad JSON must get 400s with the
              loop alive; the loop must join on stop_server() with no request
              left RUNNING. Prints the HTTP run's decode tok/s and mean TTFT
              beside the in-process run's, the time to the first streamed
              chunk, and the per-op profile of layer 0 (batch 1, 32 tokens).
8. spec     — token-tree speculative serving: a LLaMA-2-7B INT4 verifier
              (group 128) that block-embeds a 160M-class bf16 draft (both from
              seed 0), SpecEngine + SpecRequestManager (width 3, depth 4,
              fused, pipelined over LLM.compile's spec_horizon) serve the same
              8 requests, then the incremental INT4 run of the same verifier.
              Every request must finish, qmm_int4, flash_prefill and
              decode_attention must launch, the mean verified tokens per step
              must exceed 1, and each request's first 20 tokens must equal the
              incremental run's. Both runs serve every greedy horizon as
              replays of captured graphs (one per draft window bucket for
              the speculative engine), and one 8-iteration speculative
              horizon, replayed, must give the uncaptured iterations' outputs
              and caches bitwise from the same state. Prints both runs'
              decode tok/s, mean TTFT, peak memory, graphs, capture ms and
              replays, and the mean verified tokens per step. Then two
              drafts on the same verifier tensors and cache (data_ptr
              checked): draft A (width 3, depth 4) and draft B, draft A's
              weights plus seeded noise at 5% of each tensor's RMS (width
              1, depth 6), served by ``MultiSSMSpecManager`` in rotation
              (every iteration a replay of one engine's graph) and merged
              (19-node trees, 152 verifier rows, stepwise): each request's
              first 20 tokens equal the incremental run's, and each draft
              cache's committed rows, copied when its request retires, lie
              within 5e-2 relative L2 of a fresh prefill of the request's
              history (catch-up). Prints each mode's tok/s, TTFT, peak
              memory and verified tokens per step beside the one-draft run.
9. mixtral  — Mixtral-8x7B (the published config.json's widths through
              ``from_hf_config``: 32 layers, 8 experts top-2, GQA 32/8 heads,
              dense MoE form). First a 2-layer model at that width, INT8,
              a prefill of 4 requests and ``MIXTRAL_CHECK_STEPS`` = 1 decode
              step through the kernels
              on the GPU against the plain versions on the CPU: the top-2
              routing of every token at every layer equal except for tokens
              whose 2nd-vs-3rd routing-probability margin lies within twice
              the observed probability error (counted and reported); logits
              within 5% of their magnitude and greedy tokens equal where
              decided, on the rows before any token whose routing flipped. Then all 32 layers in INT8 (group 128),
              random weights from seed 0 built by the streaming quantized
              init (no bf16 tree), served as in ``serve``: every request
              finishes, every greedy step is a replay, launches equal the
              predicted per-step counts (per forward one qmm_int8 call for
              wqkv, wo and each expert's 3 projections a layer, plus the
              lm_head; one decode_attention call a layer a decode step, one
              flash_prefill call a layer a prefill), and one replayed 16-step
              horizon equals the uncaptured body bitwise. Then one batched
              prefill of the same prompts with the dense and with the ragged
              MoE form, timed; their logits at each request's last prompt
              position must agree by the cross-check's rule. Then Mixtral
              as the verifier of ``SpecEngine`` on the same weight tensors
              (data_ptr checked), with the 160M-class draft (random bf16
              weights, seed 0), width 3, depth 4, fused and pipelined: each
              request's first 20 tokens equal the incremental run's, every
              iteration is a replay, one replayed horizon equals the
              uncaptured body bitwise, qmm_int8, decode_attention and
              flash_prefill launch, and the peak memory stays within 4 GiB
              of the incremental run's. Prints the init time, decode tok/s,
              mean TTFT, peak memory, graphs and replays of both runs.
10. offload — CPU offload (``InferenceEngine(offload=True)``, the layer
              stack in pinned host memory streamed through two device slots
              on a copy stream, ``models/layer_store.py``). (a) LLaMA-2-7B INT8
              (random, seed 0, the streaming init written to host memory),
              resident then offload, the serve prompts (8 requests,
              ``OFFLOAD_A_NEW`` = 32 new tokens, decode_horizon 16,
              pipelined): every token equal, K1
              (lm_head, resident) / K3 (from the staged slot), K5 and K6
              launch. (b) Mixtral-8x7B bf16 at full width, 4 layers, resident
              then offload over one host build: the batched prefill's logits
              and 16 greedy decode steps' logits bitwise equal. (c)
              Mixtral-8x7B bf16 at full width, ``OFFLOAD_LAYERS`` = 16 layers
              (the run's time limit sets the cut), offload only: 8 requests x
              16 new tokens (horizon 1, not pipelined, so each fetch closes a
              step); prints the init and cudaHostRegister seconds, the
              host-to-device rate of one 1 GiB copy from pinned memory, the
              layer copies alone, the compute alone on the staged slots
              (a ``LayerStore`` that copies nothing), TTFT and every decode step's wall, and
              peak device memory, which must stay below 25% of the layers'
              bytes; the prefill (mean TTFT) must take less than copy-alone +
              compute-alone (the copies overlap the compute).
11. lora    — multi-adapter LoRA serving: first a 2-layer LLaMA-2-7B-width
              INT8 model with 4 adapters, a prefill of 4 requests routed
              [0, 3, -1, 1] and ``LORA_CHECK_STEPS`` = 3 teacher-forced decode steps through the
              kernels on the GPU against the plain versions on the CPU
              (logits within 5% of their magnitude, greedy tokens equal where
              decided); on every adapter row the LoRA logits differ from the
              GPU's no-LoRA logits by more than 10x that error, and the -1
              row's equal them bitwise. Then LLaMA-2-7B INT8 (32 layers,
              random weights from seed 0) serves the serve phase's 8 requests
              without adapters, and again with 4 adapters at rank 16, alpha
              32 on q, k, v, o, gate, up and down (HF PEFT's "all-linear"),
              bf16, A and B from seed 0, the requests routed [0, 1, 2, 3, 0,
              1, -1, -1], over the same weight tensors: every request
              finishes, every greedy step is a replay, qmm_int8,
              decode_attention and flash_prefill launch, the -1 requests'
              tokens equal the no-adapter run's, and one replayed 16-step
              horizon equals the uncaptured body bitwise. Prints both runs'
              decode tok/s, mean TTFT and peak memory, and the adapters'
              bytes and build time.
12. finetune — co-scheduled LoRA finetuning (``peft/finetune.FinetuneSession``)
              on LLaMA-2-7B INT8 (32 layers, random weights from seed 0),
              bf16, two adapter slots at rank 16, alpha 32 on wq and wv (the
              PEFT CLI's targets), A and B drawn; slot 0 serves, slot 1
              trains by SGD at lr 1e-3 on 4 seeded 256-token sequences, 16
              steps. (a) One step's slot-1 gradients through K1/K3 and
              ``QuantMatmulFn`` against the plain quant-matmul on the card:
              with f32 activations over the same carriers, every tensor
              (layer 0 included) at cosine >= 0.999 and relative L2 <=
              3e-2; with bf16 activations within 1.5x the floor set by a
              second plain version (the dequantized weight multiplied in
              bf16): two right bf16 forwards part by their roundings; 129
              qmm_int8 launches and 128 backwards a step; and 2 layers at
              f32 against the CPU (1e-3). (b) The serve prompts routed [0,
              -1, 0, -1, ...] through ``run_until_idle`` with the session
              registered: tokens equal the run without it, every greedy step
              a replay, each sequence's loss falls from the first epoch to
              the last. (c) Slot 1 served before and after training: tokens
              change; one replayed horizon on the trained slot equals the
              uncaptured body bitwise. (d) Slot 1 exported as an HF PEFT
              directory and loaded into a fresh engine's slot bitwise.
              Prints the step's forward, backward and update device times,
              the backward's dequant + matmul dx per carrier beside its
              bound, decode tok/s with and without the session, and peak
              memory.
13. train   — the Trainer at LLaMA-2-7B width cut to ``TRAIN_LAYERS`` = 1 layer (f32 params,
              gradients and Adam's m and v at 16 B a parameter; 32 layers
              would not fit 80 GB), seed 0, Adam at lr 1e-4: a B=1, T=64
              first step on the card against the CPU (loss rtol 1e-4,
              gradients within 1e-4 of each leaf's magnitude, updated
              parameters within 1e-5 wherever the gradient's sign is decided:
              Adam's first update is about lr * sign(g)), 8 steps on one
              4 x 512 batch (the loss must fall), and a save_checkpoint /
              load_checkpoint resume (in memory) giving the same next loss.
              Prints step ms, tokens/s and peak memory. TF32 stays off.
14. graph   — the graph layer (``ffmodel/``, ``keras/``, the frontends), f32, TF32
              off. (a) AlexNet at 3 x 224 x 224, 10 classes, Adam at 1e-3
              (``examples/alexnet.py``): a seeded batch of 8 through ``forward``
              and ``evaluate`` on the card and on the CPU with the card's
              parameters carried across (logits within 1e-4 of their
              magnitude, the loss within 1e-4, predictions equal where decided);
              the same with fusion off (within 1e-4; the substitution report
              equal to the CPU's); then 8 steps at batch 64 on one batch (the
              loss must fall). (b) The BERT-large proxy (``examples/bert_proxy.py``
              ``--large`` widths: seq 512, 16 heads, hidden 1024), SGD at 0.01,
              batch 4: 2 layers, one step on the card against the CPU (loss rtol
              1e-4, updated parameters within 1e-5 of each layer's magnitude);
              then 24 layers, 4 steps (each loss finite, the last below the
              first). (c) A Keras ``Sequential`` CNN on
              ``keras.datasets.mnist.load_data(synthetic=True)``, Adam, 2 epochs
              on the card (the epoch loss must fall). (d) A residual CNN
              ``nn.Module`` through ``from_torch_module`` on the card (within
              1e-4 of the module's own outputs there), its ``torch_ir`` round
              trip (outputs bitwise), and an ONNX MLP written by ``onnx_proto``
              (within 1e-5 of numpy). Prints each training run's step wall and
              device time (CUDA events), images/s or tokens/s, peak memory and
              model FLOPs (3x the forward's products) over the device time as a
              share of the f32 peak. No port kernel may launch on this path.
15. search  — the rewrite x placement search on one device (``parallel/``), f32,
              TF32 off. (a) ``examples/mlp_unify.py --full`` (batch 64, 1024 ->
              8 x 8192 in both towers, SGD) compiled with ``auto_parallel``
              False and True from one seed, the second taking the first's
              parameters: each graph's rewrites, the search's wall ms,
              candidates and plan cost, then 8 steps each through the graph
              phase's helper (step device and wall ms); the first losses
              within 1e-5 relative. (b) The same graph's
              ``joint_optimize(n_devices=2)`` with an ``OpCostCache`` on the
              card (bf16 matmuls timed at their sharded shapes): the cache's
              entries beside the analytic model's time for each, the search's
              wall ms, and where its views and rewrites differ from the
              analytic plan's. (c) ``Trainer(mesh="auto")`` at the train
              phase's LLaMA-2-7B width, ``TRAIN_LAYERS`` layer, 4 x 512 tokens, Adam: its
              measured step (``auto_report``) beside ``simulate_runtime``'s
              estimate over a cache timed on the card and ``analytic_cost``,
              ``estimate_memory`` beside the peak memory; then 3 steps of the
              chosen layout (the loss must fall). (d) The C5 top-k
              (``ops/topk.py``) on tied f32 and bf16 rows at the served
              shapes (routing's [8 | 104, 8], the draft's [8 | 24, 32000])
              against a stable host argsort, bitwise, timed beside the
              threshold form (``torch.topk``, then the tied tail by a
              running count) and ``torch.topk``. No port kernel may launch
              in this phase.
16. tp      — tensor and data parallel serving (``parallel/mesh.py``,
              ``parallel/sharding.py``) at the serve phase's configuration
              (LLaMA-2-7B INT8, the 8 prompts, 64 greedy tokens). (a) One
              rank over NCCL through the sharded path (the collectives
              issued, captured in the step's CUDA graph and replayed): tokens
              bitwise equal to the serve phase's (run here when serve is not
              selected), tok/s beside one device's. Then two ranks sharing
              the card over gloo (spawned; gloo collectives are not
              captured, so every horizon runs eagerly): (b) T = 2, each
              rank's cut of the one-device carriers: every request's first
              token equal to one device's (rows whose top-2 margin lies
              within twice the observed error counted and printed as
              near-ties, held all the same), prefill logits within
              ``TP_LOGITS_REL`` of their magnitude (the served decode at
              T = 2 is the dist phase's (a), on the same cut); (c) D = 2:
              every token bitwise one device's (a row's bits do not depend
              on the rows around it); (d) the spec phase's INT4 verifier
              (``TP_SPEC_LAYERS`` layers) and 160M draft at T = 2,
              ``TP_SPEC_NEW`` tokens a request: each request's first 20
              speculative tokens equal to the same cut's incremental ones; (e) Mixtral-8x7B INT8 at
              ``TP_MIXTRAL_LAYERS`` layers, full width, T = 2: first tokens
              and prefill logits against one device's at that depth, as (b).
              (f) With more than one GPU, (b) over NCCL at min(4, count)
              ranks; otherwise it says why it did not run. The ranks must
              agree on every token. Prints the phase's wall time.
17. meshtrain — gradients and adapters over a mesh (``parallel/mesh.py``'s
              autograd collectives, ``training/trainer.py``'s ``mesh=``, LoRA
              cut with the model). (a) The train phase's Trainer (LLaMA-2-7B
              width, ``TRAIN_LAYERS`` layers, f32, Adam, one seeded
              ``TRAIN_BATCH`` x ``TRAIN_LEN`` batch) on one rank over NCCL
              through the sharded path, ``MT_STEPS`` steps: losses equal to
              the one-device Trainer's, bitwise or within ``MT_ONE_RANK_REL``
              (a row-parallel f32 product may reorder its sum); step ms of
              both. Two ranks spawned sharing the card over gloo, as the tp
              phase's: (b) T = 2 and (c) D = 2 on ``MT_RANK_LAYERS`` layer
              (cut for time), ``MT_STEPS`` SGD steps: losses within 1e-5
              relative of one device's, ``full_params()`` within 1e-4 of each
              leaf's magnitude, rank 0 holding the one-device run; (c)
              prints the step's share in the gradient all-reduce (every f32
              gradient through gloo). (d) LLaMA-2-7B INT8 at
              ``MT_LORA_LAYERS`` layers, full width, f32 activations and
              cache (``MT_LORA_DTYPE``), T = 2, with the lora
              phase's 4 adapters on the seven projections, the serve prompts
              x ``MT_LORA_NEW`` = 32 tokens (cut for time) routed
              ``LORA_IDS``: every first token equal to one device's
              (near-ties counted and printed, held all the same), prefill
              logits within ``MT_LORA_LOGITS_REL`` of their magnitude; LoRA
              tok/s at T = 2 beside one device's (gloo on one card: no TP
              speed). (e) Beside (d)'s decode, ``MT_FT_STEPS`` co-scheduled
              SGD steps on adapter slot ``MT_FT_SLOT``: losses and the slot
              gathered over the ranks within 1e-3 relative of one device's.
              (f) With more than one GPU, (b)-(e) over NCCL at min(4, count)
              ranks; otherwise it says why it did not run. In the same
              two-rank spawn, the layout searches over a world of ranks
              (``parallel/auto.py``; the search phase's (a)-(d) run on one
              device): search (e) ``Trainer(mesh="auto")`` at LLaMA-2-7B width,
              ``MT_RANK_LAYERS`` layer, f32, searched at ``TRAIN_BATCH`` x
              ``TRAIN_LEN``: the report the rule's (the world's legal
              layouts ranked by ``analytic_cost``, each measured), equal on
              both ranks, and the next step under the chosen layout bitwise a
              fresh ``Trainer(mesh=make_mesh(<chosen>))``'s; (f) mlp_unify's
              CLI ``SM_UNIFY_ARGS`` (the FFModel's measured (data, model)
              search at the first batch): the report and cut equal on both
              ranks, losses within 1e-5 relative of the same CLI on one
              device; (g) ``LLM.compile(auto_parallel=True)`` at LLaMA-2-7B
              width, ``SM_LLM_LAYERS`` layers, bf16 (seeded weights): the
              chosen degrees equal on both ranks, the serve prompts x
              ``SM_LLM_NEW`` tokens, every first token equal to one device's,
              the equal tokens counted (bf16 near-ties at a cut).
18. layouts — the serving layouts left under a mesh (``parallel/sharding.py``'s
              ``hybrid_ffn`` and ``expert_parallel`` cuts, offload through
              ``models/layer_store.py`` under a mesh). (a) CPU offload under a
              mesh: LLaMA-2-7B INT8 (``LAYOUT_OFFLOAD_LAYERS`` layers, cut for
              time; ``build_params(host_layers=True, mesh=)``: each layer made,
              quantized whole, cut, fused and pinned) on one rank over NCCL
              through the sharded path, the serve prompts x
              ``LAYOUT_NEW_TOKENS`` resident then offload from one pinned
              build: every token of the offload run equal to the resident
              run's; then two ranks sharing the card over gloo at T = 2, the
              same depth and tokens, each
              rank pinning its own cut: offload tokens equal to the resident
              ones. Prints each rank's pinned GiB, the copy-alone time (every
              layer through the copy stream, no compute) and an offload decode
              step's wall. (b) ``hybrid_ffn`` at data = 2 x model = 1 over two
              gloo ranks (attention whole on each, half the FFN on each, every
              slot on every rank): LLaMA-2-7B INT8 and INT4 at
              ``LAYOUT_LAYERS`` layers in f32 activations and cache
              (``LAYOUT_HYBRID_DTYPE``: at bf16 two first tokens parted at
              near-ties), each layer's slab quantized whole then cut: every
              first token equal to one device's at that depth (near-ties
              counted and held all the same), prefill logits within
              ``LAYOUT_F32_REL``; then INT8 with offload once (tokens equal
              to the resident hybrid run's, first tokens as before). (c)
              ``expert_parallel`` at T = 2 over two gloo ranks: Mixtral-8x7B
              at ``TP_MIXTRAL_LAYERS`` layers, each rank holding 4 whole
              experts (``shard_params(expert_parallel=True)``), through
              ``decoder.forward`` (flash prefill) and ``forward_cached``
              (``LAYOUT_EP_STEPS`` greedy decode steps), in bf16 and in f32
              (``LAYOUT_EP_DTYPES``). bf16: every layer's router logits over
              the prompts' tokens are recorded on both sides and the tokens
              routed to other experts than on one device are counted, a
              layer at a time; up to a request's first such layer its
              router logits agree within ``TP_LOGITS_REL``, and the requests
              routed as on one device throughout keep their prefill logits
              within ``TP_LOGITS_REL`` and their first tokens. f32: prefill
              logits within ``LAYOUT_F32_REL``, every greedy token equal to
              one device's. The prefill's difference by request is printed.
              The expert FFN is a ``torch.matmul`` there, as on one device.
              (d) With more than one GPU, (a)-(c) over NCCL at min(4, count)
              ranks; otherwise it says why it did not run. Prints the phase's
              wall time.
19. pp      — pipeline-parallel serving (``serving/pp_engine.py``: each rank holds
              its stage's layers, KV cache and top leaves; hidden states hop
              between stages as broadcasts over two-rank gloo groups, the
              overlapped horizon's tokens return to stage 0 on a group of
              their own). Two ranks share the card over gloo (spawned; the
              engine captures no graph, every horizon runs eagerly): (a)
              LLaMA-2-7B INT8 at the serve phase's configuration (32 layers,
              the serve phase's draw, each layer's slab quantized whole and
              kept on its stage only; the 8 prompts, 64 greedy tokens,
              max_seq_len 1024, decode_horizon 16, pipelined) at P = 2,
              ``PP_MICROBATCHES`` = 2 (the overlapped horizon): every
              request's 64 tokens bitwise equal to the serve phase's (run
              here when serve is not selected); (b) INT4 at
              ``PP_INT4_LAYERS`` layers, P = 2, ``PP_INT4_MICROBATCHES`` = 4
              (tokens banked), chunked prefill at ``PP_CHUNK`` tokens: every
              token bitwise equal to the one-device engine's at the same
              settings. Each rank's layers and top leaves must be its
              stage's. Prints each rank's layer and KV GiB beside one
              device's (the stages' sum), its hops and their bytes, tok/s
              beside one device's (two ranks share one card over gloo: no
              pipeline speed) and the wall times; the ranks' launches of
              qmm_int8 / qmm_int4, decode_attention and flash_prefill are
              counted into the kernels line. (d) Tree speculation under the
              stages (``serving/pp_spec.py``): the spec phase's pair (the
              LLaMA-2-7B INT4 verifier at full width and all 32 layers,
              block-embedding the 160M bf16 draft) through
              ``PipelineSpecEngine`` at P = 2, ``PP_SPEC_MICROBATCHES`` = 2,
              each rank its stage of the verifier and the draft whole; width
              3, depth 4, the 8 prompts, ``PP_SPEC_NEW`` = 16 greedy tokens
              (cut for time), the spec phase's horizon and manager: every
              request's tokens bitwise equal to the first of the spec phase's
              one-device run (run here when spec is not
              selected), more than one verified token a step, qmm_int4,
              decode_attention and flash_prefill launched; prints each
              rank's layer, KV and draft GiB beside one device's, its hops
              and tok/s beside the spec phase's. (c) With more than one GPU,
              (a), (b) and (d) over NCCL at min(4, count) ranks; otherwise
              it says why it did not run.
20. pptrain — training under pipeline stages (``parallel/pipeline.py``'s GPipe
              step and ``pipeline_forward``, ``Trainer(pipeline_stages=)``). Two
              ranks share the card over gloo (spawned): (a) the Trainer at
              LLaMA-2-7B width, ``PT_LAYERS`` = 4 layers (two a stage), f32,
              P = 2, ``PT_MICROBATCHES`` = 2, on the meshtrain phase's seeded
              ``TRAIN_BATCH`` x ``TRAIN_LEN`` batch, ``MT_STEPS`` SGD steps at
              ``MT_SGD_LR``: every rank's losses equal, within ``PT_LOSS_REL``
              relative of the one-device Trainer's (run on rank 0 from the same
              parameters), the gathered ``full_params()`` within
              ``PT_PARAMS_REL`` of each leaf's magnitude; each rank holds its
              stage's layers and top leaves, about half the parameters (their
              sum one device's); stage 0 sends ``MT_STEPS`` x M forward hops,
              stage 1 as many backward hops (gradients). (b)
              ``pipeline_forward`` over ``PT_SIZES`` = [3, 1] stages on the same
              layers: finite f32 logits of the batch's shape within
              ``PT_LOGITS_REL`` of one device's ``decoder.forward``. Prints each
              rank's GiB beside one device's, the hops and bytes in each
              direction, the step ms beside one device's (two ranks on one
              card over gloo: no pipeline speed). No port kernel may launch
              (the Trainer's plain attention and cuBLAS in f32). (c) With more
              than one GPU, (a) and (b) over NCCL on two; otherwise it says why
              it did not run.
21. cp      — context parallelism (the mesh's ``seq`` axis: the verifier's KV
              cache cut on its positions, each layer's attention states
              merged over the seq ranks by decode_attention's shard form and
              ``merge_states``). Two ranks share the card over gloo
              (spawned): (a) LLaMA-2-7B INT8, 32 layers, the serve phase's
              draw (each layer quantized whole, replicated over seq), C = 2,
              the serve prompts x ``CP_NEW`` = 24 tokens (horizon 16): the
              ranks' tokens equal, every first token the serve phase's, each
              rank's KV half one device's, the first decode step's logits
              within ``TP_LOGITS_REL`` of one device's on the same tensors,
              the greedy tokens equal to the serve phase's counted (bf16),
              tok/s beside one device's (no context-parallel speed on one
              card), qmm_int8, decode_attention_shard, merge_states and
              flash_prefill launched and the one-device decode kernel not;
              (b) the spec phase's INT4 pair at C = 2 (the draft whole on
              each rank), the spec prompts x ``CP_NEW`` tokens (cut for
              time): the ranks' tokens equal, every first token the spec
              phase's, at least ``CP_SPEC_EQUAL`` of the tokens equal to the
              first of the spec phase's, verified tokens a step within ``CP_SPEC_VERIFIED``
              of the spec phase's; (c) LLaMA-2-7B width at
              ``CP_F32_LAYERS`` = 4 layers in f32, prompts ``CP_F32_LENS``
              (500 + 32 new tokens cross the shard boundary at 512): every
              greedy token one device's; (d) ``ops/ring_attention``'s ring
              prefill at ``CP_RING`` (S = 4096, 32 heads, D = 128, bf16)
              with and without a valid length, within ``CP_RING_TOL`` of the
              one-device plain prefill. The same two ranks then run the
              layouts and training surfaces under the seq axis: (f)
              meshtrain (d)'s LoRA model (LLaMA-2-7B INT8 at
              ``MT_LORA_LAYERS`` = 2 layers, f32, the lora phase's four
              adapters) at C = 2, the serve prompts x ``CP_NEW`` routed
              ``LORA_IDS`` with a finetuning session on slot ``MT_FT_SLOT``
              beside it:
              every token bitwise one device's (run first on rank 0 on the
              same weight tensors), both ranks' losses and slot digests
              equal, the losses within ``CP_REL`` of one device's, qmm_int8,
              the shard form, the merge and flash_prefill launched; (g)
              layouts (a)'s LLaMA-2-7B INT8 at ``LAYOUT_OFFLOAD_LAYERS``
              layers at C = 2, resident then offload over one pinned build:
              the offloaded tokens bitwise the resident run's, each rank's
              pinned and KV GiB and copy-alone s printed; (h) meshtrain
              (b)'s Trainer at C = 2: both ranks' losses equal, within
              ``CP_REL`` of one device's. Four ranks then share the card
              over gloo at P = 2 x C = 2 (spawned, killed at
              ``CP_PP_LIMIT_S``): (i) (c)'s 4-layer f32 model through
              ``PipelineInferenceEngine`` (M = 2): every token bitwise one
              device's (run first on rank 0), each stage's two seq ranks
              holding the stage's layers and its whole cache (1024
              positions), decode_attention and flash_prefill launched, the
              shard form not; (j) pptrain's Trainer (``_pt_case``) on the
              same mesh: every rank's losses equal, within ``PT_LOSS_REL`` of
              one device's, each rank its stage's layers (``full_params`` is
              gathered by pptrain (a), not here: cut for time). (e) With more
              than one GPU, (a)-(d) and (f)-(h) over NCCL at min(4, count)
              ranks; otherwise it says why it did not run.
22. dist    — multi-process serving (``parallel/distributed.py``: the controller's
              request broadcaster; the background server under a mesh). Two
              plain subprocesses formed through ``init_distributed``
              (``FF_COORDINATOR_ADDRESS``, ``FF_NUM_PROCESSES``,
              ``FF_PROCESS_ID``) share the card over gloo, each killed at
              ``DIST_LIMIT_S``; each builds the tp phase's LLaMA-2-7B INT8
              at T = 2 (``_tp_llama``). (a) ``serve_distributed``: rank 0
              broadcasts the 8 prompts, every rank serves ``DIST_NEW`` = 16
              tokens: both ranks' tokens equal, every first token the serve
              phase's (run here when serve is not selected), the tokens equal
              to the serve phase's counted (bf16 near-ties at T = 2). (b)
              ``LLM.start_server`` on both ranks: rank 0 streams one request
              and registers 3 from a thread, then 4 more from a second
              thread once the first delta has arrived; ``stop_server`` on
              both: both ranks' guids and tokens equal, every first token
              (a)'s, the deltas joined to the output, the requests equal to
              (a)'s counted. qmm_int8, decode_attention and flash_prefill
              launched in each run (rank 0's counts go into the kernels
              line). Prints the ticks and bytes broadcast, the controller's
              ms a message (mean, max), TTFT and decode tok/s as the
              controller's caller sees them beside the serve phase's, and
              the phase's wall.
23. profile — (only with ``--profile``) one 16-step decode horizon (replayed,
              then uncaptured) and one batched prefill of the served model,
              one 8-iteration speculative horizon of the spec phase
              (replayed, then uncaptured), the mixtral phase's decode
              horizon and prefill, and the lora phase's decode horizon with
              and without adapters (replayed), under ``torch.profiler``: host
              dispatch time, wall time, device busy share and the device
              time of the top 12 kernels and of every kernel of the port
              below them; for LoRA also the adapters' device time (the busy
              time the adapters add) and the kernels that grew most.

The line before the last is ``{"kernels": [...]}`` (the split-K variants'
rows also carry ``split``, their blocks along the contraction); the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import io
import json
import math
import os
import re
import shutil
import sys
import tempfile
import time

# the H100's memory rate and L2 size are tune_quant_kernel's PEAK and L2_BYTES
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor cores
PEAK_F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
PROMPT_LENS = (600, 400, 256, 128, 100, 64, 32, 17)  # the served runs' prompts
PORT_KERNELS = ("qmm_", "decode_attention", "flash_prefill")  # in the kernels' symbol names
PHASES = ("card", "build", "kernels", "variants", "crosscheck", "serve", "openai", "spec",
          "mixtral", "offload", "lora", "finetune", "train", "graph", "search", "tp", "meshtrain",
          "layouts", "pp", "pptrain", "cp", "dist", "profile")
DEFAULT_PHASES = PHASES[:-1]

LLAMA2_7B = dict(
    arch="LlamaForCausalLM", vocab_size=32000, hidden_size=4096, num_layers=32,
    num_heads=32, num_kv_heads=32, head_dim=128, intermediate_size=11008,
    max_position_embeddings=4096, norm_eps=1e-5, rope_theta=10000.0,
    bos_token_id=1, eos_token_id=None,
)
# the published config.json of mistralai/Mixtral-8x7B-v0.1 (the fields the
# spec reads); random weights, so no end-of-sequence token stops a request
MIXTRAL_8X7B = {
    "architectures": ["MixtralForCausalLM"], "vocab_size": 32000, "hidden_size": 4096,
    "intermediate_size": 14336, "num_hidden_layers": 32, "num_attention_heads": 32,
    "num_key_value_heads": 8, "num_local_experts": 8, "num_experts_per_tok": 2,
    "max_position_embeddings": 32768, "rms_norm_eps": 1e-5, "rope_theta": 1e6,
    "sliding_window": None, "tie_word_embeddings": False, "bos_token_id": 1,
    "eos_token_id": None,
}


# the lora phase's adapters: HF PEFT's target_modules="all-linear" for a LLaMA
LORA_TARGETS = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj")
LORA_IDS = [0, 1, 2, 3, 0, 1, -1, -1]  # the served requests' adapters (-1: none)
LORA_B_STD = 0.02  # B's draw: a delta about a sixth of a projection's output

# the finetune phase: the PEFT CLI's adapters (wq, wv; two slots, slot 0
# serves and slot 1 trains) at rank 16, alpha 32, and its SGD learning rate
FT_TARGETS = ("q_proj", "v_proj")
FT_IDS = [0, -1, 0, -1, 0, -1, 0, -1]  # the co-scheduled run's requests
FT_LR = 1e-3
FT_SEQS, FT_LEN, FT_STEPS = 4, 256, 16  # 4 sequences of 256 tokens, 16 SGD steps
# the train phase: LLaMA-2-7B width at 2 layers, f32, Adam, one fixed batch
# the Trainer at LLaMA-2-7B width: 1 layer (cut from 2 for the run's time: its
# first step runs on the CPU too, its checkpoint resume holds 16 B a parameter)
TRAIN_LAYERS, TRAIN_BATCH, TRAIN_LEN, TRAIN_STEPS, TRAIN_LR = 1, 4, 512, 8, 1e-4
# the cross-checks' teacher-forced decode steps (cut for the run's time: the
# CPU's plain versions dequantize every weight at every step)
CROSSCHECK_STEPS, MIXTRAL_CHECK_STEPS, LORA_CHECK_STEPS = 2, 1, 3
# the graph phase: AlexNet at 3 x 224 x 224 (examples/alexnet.py), a batch of 8
# held against the CPU and 8 Adam steps at batch 64; the BERT-large proxy
# (examples/bert_proxy.py --large: seq 512, 16 heads, hidden 1024, 24 layers) at
# batch 4, its first 2 layers held against the CPU, 4 SGD steps at full depth
GRAPH_CHECK_BATCH, GRAPH_TRAIN_BATCH, GRAPH_STEPS = 8, 64, 8
BERT_LARGE = dict(seq=512, heads=16, hidden=1024, layers=24)
BERT_BATCH, BERT_STEPS, BERT_CHECK_LAYERS = 4, 4, 2
# the search phase: examples/mlp_unify.py --full (batch 64, 1024 -> 8 x 8192 in
# both towers, SGD at 1e-3) compiled without and with the joint search; the
# Trainer's layout search at the train phase's width on 4 x 512 tokens; the C5
# top-k on tied rows at the served shapes: MoE routing (8 experts, top-2) at a
# decode step's 8 rows and a verify's 104, the draft tree's root (8 rows) and
# depths (8 x 3 beams) over a 32000-token vocabulary
UNIFY_BATCH, UNIFY_IN, UNIFY_HIDDEN, UNIFY_STEPS, UNIFY_LR = 64, 1024, (8192,) * 8, 8, 1e-3
SEARCH_BATCH, SEARCH_LEN = 4, 512
TOPK_CASES = ((8, 8, 2), (104, 8, 2), (8, 32000, 3), (24, 32000, 3))  # (rows, width, k)


class PhaseError(RuntimeError):
    pass


def log(*a):
    print(*a, flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise PhaseError(what)


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time in ms of ``fn()`` over ``reps`` launches (CUDA events,
    ``tune_quant_kernel.op_time``)."""
    import torch

    from flexflow_tpu_torch.benchmarks.tune_quant_kernel import op_time

    return op_time(lambda _: fn(), [None], reps, torch.device("cuda"), warmup) * 1e3


def attn_within(got, want, pv_abs, p_rel: float):
    """Per-element limit of a bf16 attention output against its plain version:
    one output rounding (at most 2^-7 of |want|) plus ``p_rel`` of the row's
    sum p*|v| (``pv_abs``, the plain version on |v|), which bounds the error of
    the probabilities in P.V. Returns (max |err|, max err/limit)."""
    import torch

    err = (got.float() - want.float()).abs()
    lim = 2.0 ** -7 * want.float().abs() + p_rel * pv_abs.float()
    # rows past their length are zeros on both sides: limit 0, error 0
    ratio = torch.where(err == 0, 0.0, err / lim)
    return err.max().item(), ratio.max().item()


def bound(nbytes: float, flops: float, peak_flops: float):
    from flexflow_tpu_torch.benchmarks.tune_quant_kernel import PEAK

    t_bytes = nbytes / PEAK * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# kernel phases
# ---------------------------------------------------------------------------

# the dequant-matmul design variants (ops/kernels/qmm_variants.py) and the
# lines of their TPU kernel bodies
VARIANT_LINES = {"i8_group": 40, "i4_floor": 52, "i4_3dot": 84, "i4_and": 122,
                 "i4_and_bigdot": 159, "i4_and_2dot": 184}
VARIANTS = tuple(VARIANT_LINES)
REPLACES = {
    "qmm_int8": "flexflow_tpu/ops/pallas/quant_matmul.py:46 (_int8_kernel) and :181 "
                "(_int8_kernel_idx), calls :163 / :304",
    "qmm_int4": "flexflow_tpu/ops/pallas/quant_matmul.py:58 (_int4_kernel) and :192 "
                "(_int4_kernel_idx), calls :163 / :304",
    "decode_attention": "flexflow_tpu/ops/pallas/decode_attention.py:54 (kernel), call :106",
    # K5 over a seq rank's slice of the cache, and its merge kernel across ranks
    "decode_attention_shard": "flexflow_tpu/ops/pallas/decode_attention.py:54 (kernel), call "
                              ":106, on a seq-cut cache",
    "merge_states": "flexflow_tpu/ops/pallas/decode_attention.py:54 (kernel), call :106, its "
                    "states merged across seq ranks",
    "flash_prefill": "flexflow_tpu/ops/pallas/flash_prefill.py:34 (_kernel), call :139",
    **{name: f"benchmarks/tune_int4_variants.py:{line} (_{name}_kernel), call :227 (_call :211)"
       for name, line in VARIANT_LINES.items()},
}
SOURCES = {
    "qmm_int8": "flexflow_tpu_torch/csrc/quant_matmul.cu",
    "qmm_int4": "flexflow_tpu_torch/csrc/quant_matmul.cu",
    "decode_attention": "flexflow_tpu_torch/csrc/decode_attention.cu",
    "decode_attention_shard": "flexflow_tpu_torch/csrc/decode_attention.cu",
    "merge_states": "flexflow_tpu_torch/csrc/decode_attention.cu",
    "flash_prefill": "flexflow_tpu_torch/csrc/flash_prefill.cu",
    **{name: "flexflow_tpu_torch/csrc/qmm_variants.cu" for name in VARIANTS},
}


def _qmm(qm, qa, x, layer=None, out_dtype=None):
    """The kernel on carrier ``qa`` (layer ``layer`` of a stacked one)."""
    kw = dict(group_size=qa.group_size, n_out=qa.d_rest, layer=layer,
              out_dtype=out_dtype or x.dtype)
    if qa.bits == 8:
        return qm.qmm_int8(x, qa.q, qa.scale, **kw)
    return qm.qmm_int4(x, qa.q, qa.scale, qa.offset, **kw)


def _qmm_plain(qm, qa, x, layer=None, out_dtype=None):
    """The kernel's plain PyTorch version on the same carrier."""
    pick = (lambda t: t[layer]) if layer is not None else (lambda t: t)
    od = out_dtype or x.dtype
    if qa.bits == 8:
        return qm.qmm_int8_plain(x, pick(qa.q), pick(qa.scale), qa.group_size, qa.d_rest, od)
    return qm.qmm_int4_plain(x, pick(qa.q), pick(qa.scale), pick(qa.offset), qa.group_size,
                             qa.d_rest, od)


def _weight_bytes(bits: int, d: int, f: int, g: int) -> int:
    """Bytes of one carrier at its n_out = f columns: packed weights plus the
    f32 scale (and, for INT4, offset) tables."""
    return (d * f if bits == 8 else d * f // 2) + (1 if bits == 8 else 2) * (d // g) * f * 4


def build_parent(root: str) -> dict:
    """Build each of an earlier checkout's (``root``) ``quant_matmul.cu``,
    ``flash_prefill.cu``, ``decode_attention.cu`` and ``qmm_variants.cu``
    (under ``flexflow_tpu_torch/csrc``) that exists into a library of its
    own, one nvcc each, started together, and load it beside this one.
    Returns {"quant_matmul": handle, ...} for the sources found. The earlier
    quant-matmul's entry points take no scratch pointer: ``ff_qmm_int8(x, q,
    scale, out, M, D, Fp, n_out, g, layer, x_bf16, out_f32, stream)`` and
    ``ff_qmm_int4`` with ``offset`` after ``scale``; ``ff_flash_prefill`` has
    this tree's signature; the earlier ``ff_decode_attention`` takes no
    workspace or chunk: ``(q, k_cache, v_cache, k_new, v_new, lens, idx, nx,
    self, out, B, NT, H, KH, S, D, scale, is_bf16, stream)``; the earlier
    ``ff_qmm_v_i8_group`` takes no workspace, counters or split: ``(x, q,
    scale, out, M, D, Fp, n_out, g, cols, stream)``, and ``ff_qmm_v_i4_and_2dot``
    the same with ``offset`` after ``scale``."""
    import ctypes
    import hashlib
    import subprocess
    from pathlib import Path

    from flexflow_tpu_torch.ops.kernels import _build

    P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    entries = {
        "quant_matmul": {"ff_qmm_int8": [P] * 4 + [I] * 5 + [L, I, I, P],
                         "ff_qmm_int4": [P] * 5 + [I] * 5 + [L, I, I, P]},
        "flash_prefill": {"ff_flash_prefill": _build.SIGNATURES["ff_flash_prefill"]},
        "decode_attention": {"ff_decode_attention": [P] * 10 + [I] * 6 + [F, I, P]},
        "qmm_variants": {"ff_qmm_v_i8_group": [P] * 4 + [I] * 6 + [P],
                         "ff_qmm_v_i4_and_2dot": [P] * 5 + [I] * 6 + [P]},
    }
    builds = {}
    for name in entries:
        src = Path(root) / "flexflow_tpu_torch" / "csrc" / f"{name}.cu"
        if not src.exists():
            continue
        out = _build.BUILD_ROOT / f"parent-{hashlib.sha256(src.read_bytes()).hexdigest()[:16]}"
        out.mkdir(parents=True, exist_ok=True)
        lib = out / f"lib{name}_parent.so"
        proc = None if lib.exists() else subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", str(src), "-o", str(lib)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        builds[name] = (src, lib, proc)
    require(bool(builds), f"{root} holds none of flexflow_tpu_torch/csrc/{{"
                          f"{','.join(entries)}}}.cu")
    handles = {}
    for name, (src, lib, proc) in builds.items():
        if proc is not None:
            log_text, _ = proc.communicate()
            require(proc.returncode == 0, f"building {src} failed:\n{log_text}")
        handle = ctypes.CDLL(str(lib))
        for fn, argtypes in entries[name].items():
            getattr(handle, fn).argtypes = argtypes
            getattr(handle, fn).restype = ctypes.c_int
        handles[name] = handle
    return handles


def _variant_parent(plib, name, x, qa, cols):
    """The earlier kernel of split-K variant ``name`` (``build_parent``) on
    carrier ``qa``."""
    import torch

    from flexflow_tpu_torch.ops.kernels import _build

    out = torch.empty((x.shape[0], qa.d_rest), dtype=x.dtype, device=x.device)
    tables = [qa.scale] + ([qa.offset] if qa.bits == 4 else [])
    err = getattr(plib, f"ff_qmm_v_{name}")(
        x.data_ptr(), qa.q.data_ptr(), *[t.data_ptr() for t in tables], out.data_ptr(),
        x.shape[0], x.shape[1], qa.q.shape[-1], qa.d_rest, qa.group_size, cols,
        _build.stream_ptr(x.device))
    _build.check(err, f"earlier {name}")
    return out


def _qmm_parent(plib, qa, x, layer=None, out_dtype=None):
    """The earlier kernel (``build_parent``) on carrier ``qa``."""
    import torch

    from flexflow_tpu_torch.ops.kernels import _build

    od = out_dtype or x.dtype
    out = torch.empty((x.shape[0], qa.d_rest), dtype=od, device=x.device)
    tables = [qa.scale] + ([qa.offset] if qa.bits == 4 else [])
    fn = plib.ff_qmm_int8 if qa.bits == 8 else plib.ff_qmm_int4
    err = fn(x.data_ptr(), qa.q.data_ptr(), *[t.data_ptr() for t in tables], out.data_ptr(),
             x.shape[0], x.shape[1], qa.q.shape[-1], qa.d_rest, qa.group_size, int(layer or 0),
             int(x.dtype == torch.bfloat16), int(od == torch.float32),
             _build.stream_ptr(x.device))
    _build.check(err, "earlier qmm")
    return out


def _flash_parent(plib, q, k, v, lens):
    """The earlier flash-prefill kernel (``build_parent``) on q [B, S, H, D]
    and k/v [B, S, KH, D]."""
    import torch

    from flexflow_tpu_torch.ops.kernels import _build

    out = torch.empty_like(q)
    b, s, h, d = q.shape
    err = plib.ff_flash_prefill(q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(),
                                out.data_ptr(), b, s, h, k.shape[2], d, 1.0 / math.sqrt(d),
                                int(q.dtype == torch.bfloat16), _build.stream_ptr(q.device))
    _build.check(err, "earlier flash_prefill")
    return out


def threshold_sweep(qm, qa, d: int, n_layers: int, gen, kname: str) -> None:
    """The fused 128x128 tiling against the two-pass prefill on one carrier
    at row counts around the threshold (same bits: checked), 5 launches
    each, the layers rotating."""
    import torch

    thr = qm.PREFILL_ROWS
    it = iter(range(10 ** 9))
    try:
        for m in (129, 192, 256, 512, 1024):
            x = torch.randn((m, d), generator=gen, device="cuda").to(torch.bfloat16)
            t = {}
            outs = {}
            for path, rows_from in (("tiled", 10 ** 9), ("two-pass", 0)):
                qm.PREFILL_ROWS = rows_from
                outs[path] = _qmm(qm, qa, x, 0)
                t[path] = time_ms(lambda: _qmm(qm, qa, x, next(it) % n_layers), 5)
            require(torch.equal(outs["tiled"], outs["two-pass"]),
                    f"{kname}: tiled and two-pass differ at m={m}")
            log(f"  {kname} threshold sweep m={m}: tiled {t['tiled']:.4f} ms, two-pass "
                f"{t['two-pass']:.4f} ms (bitwise equal)")
    finally:
        qm.PREFILL_ROWS = thr


def qmm_phase(bits: int, reps: int, records: list, parent=None) -> None:
    """One quant-matmul kernel (``qmm_int8`` or ``qmm_int4``) at LLaMA-2-7B's
    fused carriers and the lm_head: against its plain version, rows bitwise
    independent of the row count, (INT4) the identity probe, and timed with
    the weights rotating past L2; wgu also at each regime's edge rows, and
    the tiled and two-pass prefill side by side around the threshold. With
    ``parent`` (an earlier kernel from ``build_parent``) each timed row also
    times it, and INT8 outputs must equal its outputs bitwise."""
    import torch

    from flexflow_tpu_torch.benchmarks.tune_quant_kernel import n_copies
    from flexflow_tpu_torch.ops.kernels import quant_matmul as qm
    from flexflow_tpu_torch.parallel.sharding import slice_carrier_columns
    from flexflow_tpu_torch.quant.weight_only import dequantize, quantize

    kname = f"qmm_int{bits}"
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(bits)
    thr = qm.PREFILL_ROWS
    # rows: one decode slot, 8 decode slots, 8 slots x the 13-token tree of
    # width 3 and depth 4, and a 8192-row prefill; wgu also at each regime's
    # edges (16 | 17, 128 | 129, the prefill threshold - 1 | threshold)
    rows = (1, 8, 104, 8192)
    if bits == 8:  # and a finetune step's 256 rows (one 256-token sequence)
        rows = (1, 8, 104, FT_LEN, 8192)
    else:  # and the verify of two drafts' merged trees: 8 slots x 19 nodes
        rows = (1, 8, 104, 152, 8192)
    edges = (16, 17, 128, 129, thr - 1, thr)
    # (name, contraction shape, out width, group size, rows) of LLaMA-2-7B's
    # fused carriers; INT8's wgu again at group 64 (quantization_group_size=64),
    # whose groups are shorter than the decode tiling's 128-deep chunk
    shapes = [("wqkv", (4096,), 3 * 4096, 128, rows),
              ("wo", (32, 128), 4096, 128, rows),
              ("wgu", (4096,), 2 * 11008, 128, tuple(sorted(rows + edges))),
              ("wd", (11008,), 4096, 128, rows)]
    if bits == 8:
        shapes.append(("wgu", (4096,), 2 * 11008, 64, (8, 8192)))
        # Mixtral-8x7B's expert projections (wg / wu, and wd) at a decode
        # step's 8 rows, a speculative verify's 8 x 13 (the dense form runs
        # every expert on every row), a ragged expert group of the served
        # prefill (its 1597 valid rows x top-2 / 8 experts, ~400), a group
        # of the full 8 x 1024 bucket (2048) and the dense form's prefill (8192)
        moe_rows = (8, 104, 400, 2048, 8192)
        shapes += [("expert wg|wu", (4096,), 14336, 128, moe_rows),
                   ("expert wd", (14336,), 4096, 128, moe_rows)]
    # a tensor-parallel rank's carriers at T = 2 (the tp phase): wqkv 4096 ->
    # 6144, wo 2048 -> 4096, wgu 4096 -> 11008, wd 5504 -> 4096 (INT4: two
    # half planes of 2752 rows, so group 64); and INT8's wd at T = 4 (2752
    # rows: group 64), the halved-group cut
    tp_rows = (8, 104, 8192)
    shapes += [("T=2 rank wqkv", (4096,), 6144, 128, tp_rows),
               ("T=2 rank wo", (16, 128), 4096, 128, tp_rows),
               ("T=2 rank wgu", (4096,), 11008, 128, tp_rows),
               ("T=2 rank wd", (5504,), 4096, 128 if bits == 8 else 64, tp_rows)]
    if bits == 8:
        shapes.append(("T=4 rank wd", (2752,), 4096, 64, tp_rows))
    log(f"  prefill threshold {thr} rows: from it a bf16 call dequantizes into a [D, Fp] bf16 "
        f"scratch (peak {4096 * 32256 * 2} bytes, the lm_head's 4096 x 32256 carrier)")

    def check(name, qa, x, layer, out_dtype, rel):
        """Kernel against plain on x; rows 0 and m-1 bitwise equal to 1-row
        calls; INT8 bitwise equal to the earlier kernel where one is loaded.
        Returns (max|err|, output magnitude)."""
        got = _qmm(qm, qa, x, layer, out_dtype)
        want = _qmm_plain(qm, qa, x, layer, out_dtype)
        err = (got.float() - want.float()).abs().max().item()
        scale = want.float().abs().max().item()
        require(bool(torch.isfinite(got).all()) and err <= rel * scale,
                f"{kname} {name} m={x.shape[0]}: max|err| {err} > {rel} * {scale}")
        for r in sorted({0, x.shape[0] - 1}):
            one = _qmm(qm, qa, x[r:r + 1].contiguous(), layer, out_dtype)
            require(torch.equal(one[0], got[r]),
                    f"{kname} {name}: row {r} of a {x.shape[0]}-row call differs from a 1-row call")
        if parent is not None:
            old = _qmm_parent(parent, qa, x, layer, out_dtype)
            diff = (old.float() - got.float()).abs().max().item()
            if bits == 8:
                require(torch.equal(old, got), f"{kname} {name} m={x.shape[0]}: differs from the "
                                               f"earlier kernel by up to {diff}")
            log(f"  {kname} {name} m={x.shape[0]}: max |new - earlier kernel| {diff:.3g}")
        return err, scale

    def identity_probe(label, qa, m):
        """INT4 identity probe through the regime of an m-row call: one-hot
        rows of x (both half-planes) padded with zero rows up to m give back
        the dequantized weight's rows bitwise, f32 and rounded to bf16."""
        d = qa.q.shape[-2] * 2
        w1 = qm.int4_weight(qa.q[1], qa.scale[1], qa.offset[1], qa.group_size)[:, :qa.d_rest]
        idx = [0, d // 2 - 1, d // 2, d - 1]
        for dt in ((torch.float32, torch.bfloat16) if m == len(idx) else (torch.bfloat16,)):
            eye = torch.zeros((max(m, len(idx)), d), device=dev, dtype=dt)
            eye[torch.arange(len(idx)), idx] = 1
            require(torch.equal(_qmm(qm, qa, eye, 1)[:len(idx)], w1[idx].to(dt)),
                    f"{kname} {label} m={m}: identity probe ({dt}) differs from the weight")

    def timed(name, qa, x, n_layers, w_lib, out_dtype, err, tol):
        m, d = x.shape
        f = qa.d_rest
        stacked = n_layers is not None
        it = iter(range(10 ** 9))
        pick = (lambda: next(it) % n_layers) if stacked else (lambda: None)
        ms = time_ms(lambda: _qmm(qm, qa, x, pick(), out_dtype), reps)
        plain_ms = time_ms(lambda: _qmm_plain(qm, qa, x, pick(), out_dtype), max(2, reps // 4),
                           warmup=1)
        lib_ms = time_ms(lambda: torch.matmul(x, w_lib[next(it) % len(w_lib)]), reps)
        out_bytes = m * f * (4 if out_dtype == torch.float32 else 2)
        nbytes = x.numel() * 2 + _weight_bytes(bits, d, f, qa.group_size) + out_bytes
        b_ms, b_by = bound(nbytes, 2.0 * m * d * f, PEAK_BF16_FLOPS)
        records.append(dict(name=f"{kname}[{name} m={m}]", kernel=kname, max_abs_err=err, ms=ms,
                            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms))
        earlier = ""
        if parent is not None:  # the earlier kernel, timed in this same run
            old_ms = time_ms(lambda: _qmm_parent(parent, qa, x, pick(), out_dtype), reps)
            earlier = f" earlier {old_ms:.4f} ms"
        log(f"  {kname} {name} m={m:5d} [{qm.regime(m, d, qa.q.shape[-1], bits)}]: err {err:.3g} "
            f"(tol {tol:.3g}) kernel {ms:.4f} ms{earlier} plain {plain_ms:.4f} ms "
            f"cuBLAS-bf16 {lib_ms:.4f} ms bound {b_ms:.4f} ms ({b_by})")

    for name, cshape, f, group, mrows in shapes:
        d = math.prod(cshape)
        # enough stacked layers that the rotating weight stream exceeds L2
        n_layers = n_copies(_weight_bytes(bits, d, f, group), dev)
        w = torch.randn((n_layers, *cshape, f), generator=gen, device=dev) * (2.0 / (d + f)) ** 0.5
        qa = quantize(w, bits, group, batch_dims=1, contract_dims=len(cshape))
        require(qa.group_size == group, f"{name}: group {qa.group_size} != {group}")
        del w
        w_lib = [dequantize(type(qa)(qa.q[i], qa.scale[i],
                                     None if qa.offset is None else qa.offset[i], bits,
                                     qa.group_size, qa.shape, 1, qa.contract_dims,
                                     torch.bfloat16, qa.rest_pad)).reshape(d, f).contiguous()
                 for i in range(n_layers)]
        label = f"{name} {d}x{f} g={group}"
        # float32 activations (--full-precision) take the FMA kernel:
        # summation order only -> 1e-5 of the output's magnitude
        x32 = torch.randn((8, d), generator=gen, device=dev)
        err32, _ = check(label + " f32", qa, x32, 1, torch.float32, 1e-5)
        probe = ""
        if bits == 4:
            probe_rows = sorted({4, *mrows} - {8192})  # each regime (8192 takes the threshold's)
            for m in probe_rows:
                identity_probe(label, qa, m)
            probe = f"; identity probe bitwise (f32, bf16) at m = {probe_rows}"
        log(f"  {kname} {label} f32 x, m=8: err {err32:.3g}{probe}")
        for m in mrows:
            x = torch.randn((m, d), generator=gen, device=dev).to(torch.bfloat16)
            # tolerance: 1% of the output's magnitude - the two sum the same
            # bf16 products in f32 in different orders, then round to bf16
            err, scale = check(label, qa, x, 0, torch.bfloat16, 1e-2)
            timed(label, qa, x, n_layers, w_lib, torch.bfloat16, err, 1e-2 * scale)
        if name == "wgu" and group == 128:
            threshold_sweep(qm, qa, d, n_layers, gen, kname)
        del w_lib, qa
        torch.cuda.empty_cache()

    # shapes no LLaMA carrier has: D and F not multiples of 8 or 16 (plain
    # loads fill the ring), an odd group, a stacked layer at an unaligned
    # offset; both tilings
    d, fp, n_out, g = (1001, 300, 290, 7) if bits == 8 else (1002, 300, 290, 3)
    qa = quantize(torch.randn((2, d, fp), generator=gen, device=dev), bits, g, batch_dims=1)
    require(qa.group_size == g, f"{kname} odd shape: group {qa.group_size} != {g}")
    qa = dataclasses.replace(qa, shape=(2, d, n_out))  # n_out < the carrier's width
    for m in (7, 40):
        x = torch.randn((m, d), generator=gen, device=dev).to(torch.bfloat16)
        err, scale = check(f"D={d} F={n_out} g={g}", qa, x, 1, torch.bfloat16, 1e-2)
        log(f"  {kname} D={d} F={n_out} g={g} m={m}: err {err:.3g} (tol {1e-2 * scale:.3g}); "
            f"rows bitwise equal to 1-row calls")

    # lm_head: 4096 -> 32000 (carrier padded to 32256), f32 logits
    d, f = 4096, 32000
    w = torch.randn((d, f), generator=gen, device=dev) * (2.0 / (d + f)) ** 0.5
    qa = quantize(w, bits, 128)
    require(qa.q.shape[-1] == 32256, f"lm_head carrier width {qa.q.shape[-1]} != 32256")
    w_lib = [dequantize(qa).to(torch.bfloat16)]
    del w
    for m in rows:
        x = torch.randn((m, d), generator=gen, device=dev).to(torch.bfloat16)
        # f32 out: only the summation order differs (4096 terms)
        err, scale = check(f"lm_head {d}x{f} f32-out", qa, x, None, torch.float32, 1e-4)
        timed(f"lm_head {d}x{f} f32-out", qa, x, None, w_lib, torch.float32, err, 1e-4 * scale)
    # a T = 2 rank's vocab-parallel lm_head: columns [0, 16000) of the same
    # carrier, re-padded to 16384; whether its output equals the matching
    # columns of the whole call bit for bit is a finding, not a gate
    half = slice_carrier_columns(qa, ((0, f // 2),))
    half = dataclasses.replace(half, shape=(d, f // 2))
    require(half.q.shape[-1] == 16384, f"rank lm_head carrier width {half.q.shape[-1]} != 16384")
    w_half = [w_lib[0][:, :f // 2].contiguous()]
    for m in (8, 104, 8192):
        x = torch.randn((m, d), generator=gen, device=dev).to(torch.bfloat16)
        err, scale = check(f"T=2 rank lm_head {d}x{f // 2} f32-out", half, x, None,
                           torch.float32, 1e-4)
        same = torch.equal(_qmm(qm, half, x, None, torch.float32),
                           _qmm(qm, qa, x, None, torch.float32)[:, :f // 2])
        verdict = "bitwise equal" if same else "NOT bitwise equal"
        log(f"  {kname} T=2 rank lm_head m={m}: output {verdict} to the whole call's first "
            f"{f // 2} columns")
        timed(f"T=2 rank lm_head {d}x{f // 2} f32-out", half, x, None, w_half, torch.float32,
              err, 1e-4 * scale)
    del w_lib, w_half, qa, half
    torch.cuda.empty_cache()


def _decode_parent(plib, q, kc, vc, kn, vn, lens, index=None):
    """The earlier decode-attention kernel (``build_parent``): the one-token
    form on q [B, H, D], or the tree form on q [B, T, H, D] with ``index``
    (``tree_index``)."""
    import torch

    from flexflow_tpu_torch.ops.kernels import _build

    out = torch.empty_like(q)
    b, h, d = q.shape[0], q.shape[-2], q.shape[-1]
    nt = q.shape[1] if q.dim() == 4 else 1
    ptrs = [x.data_ptr() for x in index] if index is not None else [None] * 3
    err = plib.ff_decode_attention(
        q.data_ptr(), kc.data_ptr(), vc.data_ptr(), kn.data_ptr(), vn.data_ptr(),
        lens.data_ptr(), *ptrs, out.data_ptr(), b, nt, h, kc.shape[1], kc.shape[2], d,
        1.0 / math.sqrt(d), int(q.dtype == torch.bfloat16), _build.stream_ptr(q.device))
    _build.check(err, "earlier decode_attention")
    return out


def _cache_copies(kc, vc):
    """(k, v) cache pairs whose rotation streams past 3x the L2: ``(kc, vc)``
    and clones of it."""
    import torch

    from flexflow_tpu_torch.benchmarks.tune_quant_kernel import n_copies

    n = n_copies(2 * kc.numel() * kc.element_size(), torch.device("cuda"))
    return [(kc, vc)] + [(kc.clone(), vc.clone()) for _ in range(n - 1)]


def decode_attention_phase(reps: int, records: list, parent=None) -> None:
    """K5 against its plain version in both forms (and, with ``parent``, the
    earlier kernel against the same limit), at LLaMA-2-7B heads, GQA, MQA,
    f32 and lengths at the chunk's edges; each tree node checked bitwise
    against the one-token call after its ancestors were committed. Timed at
    the 7B shape, the served decode's lengths (LLaMA-2-7B's heads and
    Mixtral-8x7B's GQA), one long request and the speculative verify's
    tree, each rotating through caches past the L2."""
    import torch
    import torch.nn.functional as F

    from flexflow_tpu_torch.ops.kernels import decode_attention as da

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    bf16, f32 = torch.bfloat16, torch.float32
    c = da.CHUNK
    # (label, B, H, KH, S, D, dtype, lens, timed): LLaMA-2-7B MHA decode at
    # lengths 1024..0, at the served decode's lengths (the served prompts
    # plus ~32 generated tokens), Mixtral-8x7B's GQA (32 query heads on 8
    # KV heads) at the same lengths, and one 4096-position request; GQA,
    # MQA, f32, and lengths at the chunk's edges at D = 256 with groups of 16
    served = [632, 432, 288, 160, 132, 96, 64, 49]
    cases = [
        ("", 8, 32, 32, 1024, 128, bf16, [1024, 1000, 777, 600, 512, 300, 100, 0], True),
        (" serve", 8, 32, 32, 1024, 128, bf16, served, True),
        (" serve", 8, 32, 8, 1024, 128, bf16, served, True),
        (" serve T=2", 8, 16, 16, 1024, 128, bf16, served, True),  # a T = 2 rank's heads
        (" long", 1, 32, 32, 4096, 128, bf16, [4096], True),
        ("", 8, 32, 32, 1024, 128, f32, [1024, 1000, 777, 600, 512, 300, 100, 0], False),
        ("", 4, 32, 8, 512, 128, bf16, [512, 64, 1, 300], False),
        ("", 4, 16, 1, 512, 64, bf16, [500, 0, 17, 512], False),
        (" edges", 5, 64, 4, 200, 256, bf16, [c - 1, c, c + 1, 0, 1], False),
    ]
    tol_bf16 = "2^-7|want| + 2^-12 sum p|v|"

    def within(got, want, pv):
        if got.dtype == bf16:
            # f32 softmax and P.V (fast exp, summation order): 2^-12 of
            # sum p|v|, far above their error, plus the output rounding
            return attn_within(got, want, pv, 2.0 ** -12)
        err = (got - want).abs().max().item()  # fast exp and summation order only
        return err, err / 1e-4

    def held(what, fns, want, pv):
        """Each (who, fn) output against ``want``; returns {who: (err, ratio)}."""
        errs = {}
        for who, fn in fns:
            got = fn()
            require(bool(torch.isfinite(got).all()), f"{what}: {who} output not finite")
            errs[who] = within(got, want, pv)
            require(errs[who][1] <= 1, f"{what}: {who} max|err| {errs[who][0]}, "
                                       f"{errs[who][1]:.3g} x the limit")
        return errs

    def report(what, errs, tol, extra=""):
        err, ratio = errs["kernel"]
        earlier = (f" [earlier kernel {errs['earlier kernel'][0]:.3g}]"
                   if "earlier kernel" in errs else "")
        log(f"  {what}: err {err:.3g} ({ratio:.3g} x the limit {tol}){earlier}{extra}")

    def timed(name, fns, plain, lib, nbytes, flops, err):
        ms = time_ms(fns[0][1], reps)
        earlier = ""
        if len(fns) > 1:
            earlier = f" [earlier kernel {time_ms(fns[1][1], reps):.4f} ms]"
        plain_ms = time_ms(plain, max(2, reps // 4), 1)
        lib_ms = time_ms(lib, reps)
        b_ms, b_by = bound(nbytes, flops, PEAK_F32_FLOPS)
        records.append(dict(name=f"decode_attention[{name}]", kernel="decode_attention",
                            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                            bound_by=b_by, library_ms=lib_ms))
        log(f"    kernel {ms:.4f} ms{earlier} plain {plain_ms:.4f} ms SDPA {lib_ms:.4f} ms "
            f"({ms / lib_ms:.2f}x) bound {b_ms:.4f} ms ({b_by})")

    for label, b, h, kh, s, d, dt, lens_l, is_timed in cases:
        def rnd(*shape):
            return torch.randn(shape, generator=gen, device=dev).to(dt)

        q, kc, vc = rnd(b, h, d), rnd(b, kh, s, d), rnd(b, kh, s, d)
        ks, vs = rnd(b, kh, d), rnd(b, kh, d)
        lens = torch.tensor(lens_l, dtype=torch.int32, device=dev)
        want = da.decode_attention_plain(q, kc, vc, ks, vs, lens)
        pv = None
        if dt == bf16:
            pv = da.decode_attention_plain(q.float(), kc.float(), vc.float().abs(),
                                           ks.float(), vs.float().abs(), lens)
        caches = _cache_copies(kc, vc) if is_timed else [(kc, vc)]
        it = iter(range(10 ** 9))

        def nxt():
            return caches[next(it) % len(caches)]

        fns = [("kernel", lambda: da.decode_attention(q, *nxt(), ks, vs, lens))]
        if parent is not None:
            fns.append(("earlier kernel",
                        lambda: _decode_parent(parent, q, *nxt(), ks, vs, lens)))
        what = f"decode_attention{label} B={b} H={h} KH={kh} S={s} D={d} {str(dt)[6:]}"
        errs = held(what, fns, want, pv)
        report(what, errs, tol_bf16 if dt == bf16 else "1e-4")
        del want, pv
        if not is_timed:
            continue
        # yardstick: SDPA over [cache | self] with the length mask
        alls = [(torch.cat([k, ks[:, :, None]], dim=2), torch.cat([v, vs[:, :, None]], dim=2))
                for k, v in caches]
        pos = torch.arange(s + 1, device=dev)
        mask = ((pos[None] < lens[:, None]) | (pos[None] == s))[:, None, None, :]
        q4 = q[:, :, None]
        tot = int(sum(min(max(x, 0), s) for x in lens_l))
        nbytes = (2 * tot * kh * d + 2 * q.numel() + 2 * ks.numel()) * q.element_size() + 4 * b
        timed(f"B={b} H={h} KH={kh} S={s} D={d} bf16" + (f" lens={label.strip()}" if label else ""),
              fns, lambda: da.decode_attention_plain(q, *nxt(), ks, vs, lens),
              lambda: F.scaled_dot_product_attention(q4, *alls[next(it) % len(alls)],
                                                     attn_mask=mask, enable_gqa=h != kh),
              nbytes, 4.0 * h * d * (tot + b), errs["kernel"][0])
        del caches, alls
        torch.cuda.empty_cache()

    # the tree form: the speculative verify's 8 slots x the 13-node tree of
    # width 3 and depth 4 (random parents) at LLaMA-2-7B's heads and at
    # Mixtral-8x7B's GQA, and the merged tree of two drafts (3 x 4 and 1 x 6,
    # tokens from a 3-token vocabulary so that they share prefixes: 19 slots,
    # irregular parents, padding slots that attend only themselves)
    lens_l = list(PROMPT_LENS)
    tree_cases = [("", 32, 32, _beam_trees(6, 8, 3, 4)), (" GQA", 32, 8, _beam_trees(6, 8, 3, 4)),
                  (" T=2", 16, 16, _beam_trees(6, 8, 3, 4))]
    merged = _merged_trees(7, 8, [(3, 4), (1, 6)])
    tree_cases.append((" merged", 32, 32, merged))
    for label, h, kh, parents in tree_cases:
        tree_phase_case(label, h, kh, parents, lens_l, gen, held, report, timed, tol_bf16,
                        parent)


def _beam_trees(seed: int, b: int, width: int, depth: int, vocab: int = 0):
    """[B, 1 + width x depth] parents in ``SpecEngine.draft_tree``'s layout
    (slot 1 + (d - 1) W + w; each parent a random slot of the previous
    depth), and with ``vocab`` the tokens drawn from it (root 0); numpy."""
    import numpy as np

    rng = np.random.default_rng(seed)
    t = 1 + width * depth
    parents = np.full((b, t), -1, np.int32)
    parents[:, 1:1 + width] = 0
    for d in range(2, depth + 1):
        base, prev = 1 + (d - 1) * width, 1 + (d - 2) * width
        parents[:, base:base + width] = prev + rng.integers(0, width, (b, width))
    if not vocab:
        return parents
    tokens = rng.integers(0, vocab, (b, t)).astype(np.int32)
    tokens[:, 0] = 0
    return tokens, parents


def _merged_trees(seed: int, b: int, shapes):
    """The parents [B, 1 + sum(W D)] of ``tree_merge.merge_batch`` over one
    draft tree of each (width, depth) in ``shapes``, tokens from a 3-token
    vocabulary (shared prefixes dedup; padding slots have parent -2)."""
    from flexflow_tpu_torch.serving.tree_merge import merge_batch

    trees = [_beam_trees(seed + i, b, w, d, vocab=3) for i, (w, d) in enumerate(shapes)]
    t = 1 + sum(w * d for w, d in shapes)
    return merge_batch(trees, t, t)[1]


def tree_phase_case(label, h, kh, parents, lens_l, gen, held, report, timed, tol_bf16,
                    parent) -> None:
    """K5's tree form on 8 slots of one tree each (``parents`` [B, T]; -1 the
    root, -2 a padding slot that attends only itself) against its plain
    version, each checked node bitwise equal to the one-token call after its
    ancestors were committed, then timed rotating through caches past L2."""
    import torch
    import torch.nn.functional as F

    from flexflow_tpu_torch.ops.kernels import decode_attention as da

    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    s, d = 1024, 128
    parents = torch.as_tensor(parents, dtype=torch.long)
    b, t = parents.shape
    anc = torch.eye(t, dtype=torch.bool).repeat(b, 1, 1)
    for cc in range(1, t):
        ok = parents[:, cc] >= 0
        anc[ok, cc] |= anc[ok.nonzero()[:, 0], parents[ok, cc]]
    anc = anc.to(dev)
    lens = torch.tensor(lens_l, dtype=torch.int32, device=dev)
    pads = int((parents == -2).sum())

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf16)

    q, kn, vn = rnd(b, t, h, d), rnd(b, t, kh, d), rnd(b, t, kh, d)
    kc, vc = rnd(b, kh, s, d), rnd(b, kh, s, d)
    index = da.tree_index(anc)
    want = da.tree_attention_plain(q, kc, vc, kn, vn, lens, anc)
    pv = da.tree_attention_plain(q.float(), kc.float(), vc.float().abs(), kn.float(),
                                 vn.float().abs(), lens, anc)
    caches = _cache_copies(kc, vc)
    it = iter(range(10 ** 9))

    def nxt():
        return caches[next(it) % len(caches)]

    fns = [("kernel", lambda: da.tree_attention(q, *nxt(), kn, vn, lens, anc, index=index))]
    if parent is not None:
        fns.append(("earlier kernel",
                    lambda: _decode_parent(parent, q, *nxt(), kn, vn, lens, index)))
    what = f"decode_attention tree{label} B={b} T={t} H={h} KH={kh} S={s} D={d} bfloat16"
    errs = held(what, fns, want, pv)
    del want, pv
    got = da.tree_attention(q, kc, vc, kn, vn, lens, anc)
    # each node bitwise equal to the one-token call after its ancestors were
    # committed into the cache at lens, lens + 1, ... (incremental decoding):
    # every node of slots 0 and 5 (padding slots included), and two of slot 7
    nodes = [(0, cc) for cc in range(t)] + [(5, cc) for cc in range(t)] + [(7, 1), (7, t - 2)]
    for bi, cc in nodes:
        path = anc[bi, cc].nonzero()[:, 0].tolist()
        n = lens_l[bi]
        ck, cv = kc[bi:bi + 1].clone(), vc[bi:bi + 1].clone()
        for j, a in enumerate(path[:-1]):
            ck[0, :, n + j] = kn[bi, a]
            cv[0, :, n + j] = vn[bi, a]
        one = da.decode_attention(q[bi:bi + 1, cc].contiguous(), ck, cv,
                                  kn[bi:bi + 1, cc].contiguous(), vn[bi:bi + 1, cc].contiguous(),
                                  torch.tensor([n + len(path) - 1], dtype=torch.int32,
                                               device=dev))
        require(torch.equal(one[0], got[bi, cc]),
                f"tree attention{label}: slot {bi} node {cc} differs from the one-token call")
    report(what, errs, tol_bf16, f"; {len(nodes)} nodes bitwise equal to one-token calls"
                                 f"{f'; {pads} padding slots' if pads else ''}")
    # yardstick: SDPA over [cache | tree] with the joint mask
    alls = [(torch.cat([k, kn.transpose(1, 2)], dim=2), torch.cat([v, vn.transpose(1, 2)], 2))
            for k, v in caches]
    pos = torch.arange(s, device=dev)
    mask = torch.cat([(pos[None, None] < lens[:, None, None]).expand(b, t, s), anc], dim=-1)[:, None]
    qt = q.transpose(1, 2)
    # bytes: the valid cache rows once, q, the tree's K/V and the output;
    # operations: 4 per (query head, element, attended column)
    cols = sum(t * n for n in lens_l) + int(anc.sum())
    nbytes = (2 * sum(lens_l) * kh * d + 2 * q.numel() + 2 * kn.numel()) * 2 + 4 * b
    timed(f"tree{label} B={b} T={t} H={h} KH={kh} S={s} D={d} bf16", fns,
          lambda: da.tree_attention_plain(q, *nxt(), kn, vn, lens, anc),
          lambda: F.scaled_dot_product_attention(qt, *alls[next(it) % len(alls)], attn_mask=mask,
                                                 enable_gqa=h != kh),
          nbytes, 4.0 * h * d * cols, errs["kernel"][0])
    del caches, alls
    torch.cuda.empty_cache()


SHARD_DEGREES = (1, 2, 4)  # the seq degrees the kernels phase cuts one cache into
# the served decode's lengths (632...49) with 512 and 256 on shard boundaries
# (512 at C = 2 and 4, 256 at C = 4); at C = 4 the 49-token slot leaves
# three shards without a position
SHARD_LENS = [632, 512, 288, 256, 132, 96, 64, 49]
# past one bf16 ulp of the one-device kernel's value: the f32 summation
# order's error, of the row's sum p|v| (a few f32 roundings of it)
SHARD_F32_REL = 2.0 ** -20


def _bf16_ulp(x):
    """One bf16 ulp of each element of ``x`` (8 significant bits)."""
    import torch

    return torch.ldexp(torch.ones_like(x, dtype=torch.float32),
                       torch.frexp(x.float()).exponent - 8)


def shard_phase_case(label, q, kc, vc, kn, vn, lens, tree, index, reps, records) -> None:
    """K5's shard form on C = 1, 2 and 4 slices of one cache (``tree``: the
    tree form's mask, else the one-token form) and the cross-rank merge:
    the merged output against the plain versions (state and merge), bitwise
    the one-device kernel's at C = 1 and within one bf16 ulp of it at C = 2
    and 4; seq rank 0's shard call (the in-flight items and the most
    positions) and the merge timed, each rotating through copies past L2."""
    import torch
    import torch.nn.functional as F

    from flexflow_tpu_torch.benchmarks.tune_quant_kernel import n_copies
    from flexflow_tpu_torch.ops.kernels import decode_attention as da

    dev = q.device
    b, h, d = q.shape[0], q.shape[-2], q.shape[-1]
    kh, s = kc.shape[1], kc.shape[2]
    t = 1 if tree is None else q.shape[1]
    lens_l = lens.tolist()
    if tree is None:
        one = da.decode_attention(q, kc, vc, kn, vn, lens)
    else:
        one = da.tree_attention(q, kc, vc, kn, vn, lens, tree, index=index)

    def state(kernel, r, w, kb, vb):
        if tree is None:
            f = da.decode_attention_state if kernel else da.decode_attention_state_plain
            return f(q, kb, vb, kn, vn, lens, first=r * w, inflight=r == 0)
        if kernel:
            return da.tree_attention_state(q, kb, vb, kn, vn, lens, tree, first=r * w,
                                           inflight=r == 0, index=index)
        return da.tree_attention_state_plain(q, kb, vb, kn, vn, lens, tree, first=r * w,
                                             inflight=r == 0)

    def stacked(states):  # C states of [B, (T,) H, D + 2] -> [rows, H, C, D + 2]
        return torch.stack(states, dim=-2).reshape(b * t, h, len(states), d + 2)

    # the plain version on |v|: the scale of the P.V error (attn_within)
    absv = (q.float(), kc.float(), vc.float().abs(), kn.float(), vn.float().abs(), lens)
    pv = (da.decode_attention_plain(*absv) if tree is None
          else da.tree_attention_plain(*absv, tree))
    for c in SHARD_DEGREES:
        w = s // c
        blocks = [(kc[:, :, r * w:(r + 1) * w].contiguous(), vc[:, :, r * w:(r + 1) * w]
                   .contiguous()) for r in range(c)]
        held_n = [sum(min(max(n - r * w, 0), w) for n in lens_l) for r in range(c)]
        k_states = stacked([state(True, r, w, *blk) for r, blk in enumerate(blocks)])
        p_states = stacked([state(False, r, w, *blk) for r, blk in enumerate(blocks)])
        got = da.merge_states(k_states, q.dtype).reshape(one.shape)
        want = da.merge_states_plain(p_states, q.dtype).reshape(one.shape)
        what = f"decode_attention_shard{label} C={c}"
        require(bool(torch.isfinite(got).all()), f"{what}: output not finite")
        err, ratio = attn_within(got, want, pv, 2.0 ** -12)
        require(ratio <= 1, f"{what}: max|err| {err} against the plain versions, {ratio:.3g} "
                            "x the limit")
        diff = (got.float() - one.float()).abs()
        if c == 1:
            require(torch.equal(got, one), f"{what}: not bitwise the one-device kernel")
            vs_one = "bitwise the one-device kernel"
        else:
            # one bf16 ulp of the value, plus the f32 summation order's error
            # (the C states merged after their chunks, not the chunks at once),
            # which shows on values near zero: SHARD_F32_REL of the row's sum p|v|
            ulp = _bf16_ulp(one)
            over = diff > ulp
            beyond = ((diff - ulp) / pv.float()).max().item()
            require(beyond <= SHARD_F32_REL,
                    f"{what}: {beyond:.3g} x sum p|v| past one bf16 ulp of the one-device kernel")
            vs_one = (f"{int((diff > 0).sum())} of {diff.numel()} values differ from the "
                      f"one-device kernel, {int(over.sum())} by more than one bf16 ulp (at most "
                      f"{(diff / ulp).max().item():.3g} ulp, {max(beyond, 0):.3g} x sum p|v| "
                      f"past it, limit {SHARD_F32_REL:g})")
        log(f"  {what}: err {err:.3g} ({ratio:.3g} x the limit 2^-7|want| + 2^-12 sum p|v|) "
            f"against the plain state and merge; {vs_one}; positions a shard {held_n}")
        # seq rank 0's shard call, rotating through copies of its block
        copies = _cache_copies(*blocks[0])
        it = iter(range(10 ** 9))

        def nxt():
            return copies[next(it) % len(copies)]

        ms = time_ms(lambda: state(True, 0, w, *nxt()), reps)
        plain_ms = time_ms(lambda: state(False, 0, w, *nxt()), max(2, reps // 4), 1)
        # yardstick: SDPA over rank 0's positions and the in-flight items
        # (the output, not the state)
        pos = torch.arange(w, device=dev)
        valid = pos[None] < lens[:, None]  # [B, w]
        if tree is None:
            alls = [(torch.cat([kb, kn[:, :, None]], 2), torch.cat([vb, vn[:, :, None]], 2))
                    for kb, vb in copies]
            mask = torch.cat([valid, torch.ones(b, 1, dtype=torch.bool, device=dev)],
                             1)[:, None, None]
            qs = q[:, :, None]
        else:
            alls = [(torch.cat([kb, kn.transpose(1, 2)], 2), torch.cat([vb, vn.transpose(1, 2)],
                                                                       2)) for kb, vb in copies]
            mask = torch.cat([valid[:, None].expand(b, t, w), tree], -1)[:, None]
            qs = q.transpose(1, 2)
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qs, *alls[next(it) % len(alls)], attn_mask=mask, enable_gqa=h != kh), reps)
        esz = q.element_size()
        nbytes = ((2 * held_n[0] * kh * d + q.numel() + 2 * kn.numel()) * esz + 4 * b
                  + 4 * b * t * h * (d + 2))
        cols = (held_n[0] + b) * t if tree is None else t * held_n[0] + int(tree.sum())
        b_ms, b_by = bound(nbytes, 4.0 * h * d * cols, PEAK_F32_FLOPS)
        name = f"decode_attention_shard[C={c} rank 0{label} B={b} H={h} KH={kh} S={s} D={d} bf16]"
        records.append(dict(name=name, kernel="decode_attention_shard", max_abs_err=err, ms=ms,
                            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms))
        log(f"    shard (rank 0, {held_n[0]} positions) kernel {ms:.4f} ms plain {plain_ms:.4f} "
            f"ms SDPA {lib_ms:.4f} ms bound {b_ms:.4f} ms ({b_by})")
        # the cross-rank merge of the C gathered states, apart
        st_copies = [k_states] + [k_states.clone() for _ in range(n_copies(
            k_states.numel() * 4, dev) - 1)]
        mms = time_ms(lambda: da.merge_states(st_copies[next(it) % len(st_copies)], q.dtype), reps)
        mplain = time_ms(lambda: da.merge_states_plain(k_states, q.dtype), max(2, reps // 4), 1)
        m_err = (got.float() - want.float()).abs().max().item()
        mbytes = k_states.numel() * 4 + got.numel() * esz
        mb_ms, mb_by = bound(mbytes, 3.0 * k_states.numel(), PEAK_F32_FLOPS)
        records.append(dict(name=f"merge_states[C={c}{label} rows={b * t} H={h} D={d} bf16]",
                            kernel="merge_states", max_abs_err=m_err, ms=mms, plain_ms=mplain,
                            bound_ms=mb_ms, bound_by=mb_by, library_ms=None))
        log(f"    merge of {c} states kernel {mms:.4f} ms plain {mplain:.4f} ms bound "
            f"{mb_ms:.4f} ms ({mb_by})")
        del copies, alls, st_copies
        torch.cuda.empty_cache()


def decode_attention_shard_phase(reps: int, records: list) -> None:
    """K5's shard form (context parallelism: one slice of the cache's
    positions a seq rank) and the cross-rank merge on C = 1, 2 and 4 slices
    at the served shapes: LLaMA-2-7B's heads and Mixtral-8x7B's GQA at the
    served decode's lengths (``SHARD_LENS``: slots on shard boundaries and
    shards without a position), and the verify's 13-node tree at the served
    prompts' lengths."""
    import torch

    from flexflow_tpu_torch.ops.kernels import decode_attention as da

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    bf16 = torch.bfloat16
    s, d, b = 1024, 128, 8

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf16)

    for label, h, kh in ((" serve", 32, 32), (" serve GQA", 32, 8)):
        lens = torch.tensor(SHARD_LENS, dtype=torch.int32, device=dev)
        shard_phase_case(label, rnd(b, h, d), rnd(b, kh, s, d), rnd(b, kh, s, d), rnd(b, kh, d),
                         rnd(b, kh, d), lens, None, None, reps, records)
    parents = torch.as_tensor(_beam_trees(6, b, 3, 4), dtype=torch.long)
    t = parents.shape[1]
    anc = torch.eye(t, dtype=torch.bool).repeat(b, 1, 1)
    for cc in range(1, t):
        ok = parents[:, cc] >= 0
        anc[ok, cc] |= anc[ok.nonzero()[:, 0], parents[ok, cc]]
    anc = anc.to(dev)
    lens = torch.tensor(list(PROMPT_LENS), dtype=torch.int32, device=dev)
    shard_phase_case(" tree", rnd(b, t, 32, d), rnd(b, 32, s, d), rnd(b, 32, s, d),
                     rnd(b, t, 32, d), rnd(b, t, 32, d), lens, anc, da.tree_index(anc), reps,
                     records)


def flash_prefill_phase(reps: int, records: list, parent=None) -> None:
    """K6 against its plain version (and, with ``parent``, the earlier kernel
    against the same limit) at LLaMA-2-7B heads, GQA, MQA and f32; timed at
    the 7B shape, at the served prefills' shapes (the verifier's, Mixtral's
    GQA and the draft's heads at the served prompts' lengths) and with every
    row full, where SDPA-causal does the kernel's own work."""
    import torch
    import torch.nn.functional as F

    from flexflow_tpu_torch.ops.kernels import flash_prefill as fp

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    bf16, f32 = torch.bfloat16, torch.float32
    served = list(PROMPT_LENS)
    # (label, B, S, H, KH, D, dtype, lens, timed)
    cases = [
        ("", 8, 1024, 32, 32, 128, bf16, [1024, 900, 700, 512, 300, 128, 64, 17], True),
        ("", 2, 200, 32, 8, 128, bf16, [200, 77], False),  # GQA, S not a tile multiple
        ("", 2, 256, 16, 1, 64, bf16, [256, 5], False),  # MQA
        ("", 2, 300, 32, 32, 128, f32, [300, 150], False),  # --full-precision
        # the served prefills: the serve phase's 8 x 1024 bucket, the
        # mixtral phase's (GQA, 8 KV heads), and the spec phase's draft
        # (6 heads) on the same prompts
        (" serve", 8, 1024, 32, 32, 128, bf16, served, True),
        (" serve", 8, 1024, 32, 8, 128, bf16, served, True),
        (" draft", 8, 1024, 6, 6, 128, bf16, served, True),
        (" serve T=2", 8, 1024, 16, 16, 128, bf16, served, True),  # a T = 2 rank's heads
        # every row full: SDPA-causal's work equals the kernel's
        (" full", 8, 1024, 32, 32, 128, bf16, [1024] * 8, True),
    ]
    for label, b, s, h, kh, d, dt, lens_l, timed in cases:
        def rnd(*shape):
            return torch.randn(shape, generator=gen, device=dev).to(dt)

        q, k, v = rnd(b, s, h, d), rnd(b, s, kh, d), rnd(b, s, kh, d)
        lens = torch.tensor(lens_l, dtype=torch.int32, device=dev)
        want = fp.flash_prefill_plain(q, k, v, lens)
        if dt == bf16:
            # bf16 probabilities in P.V: each p rounds by at most 2^-9, so
            # 2^-8 of sum p|v| is twice their worst case; plus the output rounding
            pv = fp.flash_prefill_plain(q.float(), k.float(), v.float().abs(), lens)
            tol = "2^-7|want| + 2^-8 sum p|v|"

            def within(got):
                return attn_within(got, want, pv, 2.0 ** -8)
        else:  # fast exp and summation order only
            tol = "1e-4"

            def within(got):
                err = (got - want).abs().max().item()
                return err, err / 1e-4
        what = f"flash_prefill{label} B={b} S={s} H={h} KH={kh} D={d} {str(dt)[6:]}"
        kernels = [("kernel", lambda: fp.flash_prefill(q, k, v, lens))]
        if parent is not None:
            kernels.append(("earlier kernel", lambda: _flash_parent(parent, q, k, v, lens)))
        errs = {}
        for who, fn in kernels:
            got = fn()
            require(bool(torch.isfinite(got).all()), f"{what}: {who} output not finite")
            errs[who] = within(got)
            require(errs[who][1] <= 1, f"{what}: {who} max|err| {errs[who][0]}, "
                                       f"{errs[who][1]:.3g} x the limit {tol}")
        err, ratio = errs["kernel"]
        earlier = ""
        if parent is not None:
            earlier = f" [earlier kernel {errs['earlier kernel'][0]:.3g}]"
        log(f"  {what}: err {err:.3g} ({ratio:.3g} x the limit {tol}){earlier}")
        if not timed:
            continue
        ms = time_ms(kernels[0][1], reps)
        if parent is not None:
            earlier = f" [earlier kernel {time_ms(kernels[1][1], reps):.4f} ms]"
        plain_ms = time_ms(lambda: fp.flash_prefill_plain(q, k, v, lens), max(2, reps // 4), 1)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                                enable_gqa=h != kh), reps)
        pairs = sum(n * (n + 1) // 2 for n in lens_l)
        # the valid q/k/v rows are read (no row at or past its length is
        # loaded); every output row is written
        valid = sum(min(n, s) for n in lens_l)
        nbytes = (valid * (h + 2 * kh) * d + b * s * h * d) * 2 + 4 * b
        b_ms, b_by = bound(nbytes, 4.0 * h * d * pairs, PEAK_BF16_FLOPS)
        name = f"B={b} S={s} H={h} KH={kh} D={d} bf16" + (f" lens={label.strip()}" if label else "")
        records.append(dict(name=f"flash_prefill[{name}]", kernel="flash_prefill",
                            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                            bound_by=b_by, library_ms=lib_ms))
        log(f"    kernel {ms:.4f} ms{earlier} plain {plain_ms:.4f} ms SDPA-causal {lib_ms:.4f} ms "
            f"({ms / lib_ms:.2f}x) bound {b_ms:.4f} ms ({b_by})")
        torch.cuda.empty_cache()


def variants_phase(reps: int, records: list, parent=None) -> dict:
    """The quant-kernel tuning path at its full shape, with the launch counts
    set to 0 just before and read just after; then, on the tuning run's own
    x and carriers, each variant at each column width against its plain
    version and by its identity probe, timed beside its plain version and
    ``torch.matmul`` on the pre-dequantized bf16 weight (both rotating past
    L2, as the tuning run's kernel times do). The split-K variants
    (``qmm_variants.SPLIT_K``) must give the same bits on a second call; with
    ``parent`` (``build_parent``'s ``qmm_variants``) the earlier kernel of
    each is held to the same 1% of its plain version and timed beside it in
    turns (earlier, new, new, earlier)."""
    import torch

    from flexflow_tpu_torch.benchmarks import tune_int4_variants as tv
    from flexflow_tpu_torch.benchmarks import tune_quant_kernel as tq
    from flexflow_tpu_torch.ops.kernels import qmm_variants as qv
    from flexflow_tpu_torch.ops.kernels import quant_matmul as qm
    from flexflow_tpu_torch.quant.weight_only import dequantize

    d, f, b, g = 4096, 11008, 8, 128
    dev = torch.device("cuda")
    _launches(reset=True)
    cases, data = tv.run(d, f, b, g, device=dev, reps=reps)
    torch.cuda.synchronize()
    launches = _launches()
    failed = [r["name"] for r in cases if not r["ok"]]
    require(not failed, f"tuning cases failed: {failed}")
    for name in VARIANTS:
        require(launches[name] > 0, f"{name} was never launched by the tuning path")

    x, qa, rot = data["x"], data["qa"], data["rot"]
    weight = {8: (qa[8].q.float() * torch.repeat_interleave(qa[8].scale, g, dim=0))[:, :f],
              4: qm.int4_weight(qa[4].q, qa[4].scale, qa[4].offset, g)[:, :f]}
    idx = [0, d // 2 - 1, d // 2, d - 1]
    eye = torch.zeros((len(idx), d), device=dev, dtype=torch.bfloat16)
    eye[torch.arange(len(idx)), idx] = 1
    lib_ms, plain_ms = {}, {}
    for bits in (8, 4):
        w_lib = [dequantize(c) for c in rot[bits][:tq.n_copies(d * f * 2, dev)]]
        lib_ms[bits] = tq.op_time(lambda w: torch.matmul(x, w), w_lib, reps, dev) * 1e3
        del w_lib
    nbytes = {bits: x.numel() * 2 + _weight_bytes(bits, d, f, g) + b * f * 2 for bits in (8, 4)}
    earlier = {}
    for r in cases:
        name, cols, bits = r["variant"], r["cols"], r["bits"]
        if cols is None:
            continue
        split = r["split"]
        label = f"{name} cols={cols} B={b} {d}x{f} g={g}"
        got = qv.variant(name, x, qa[bits], cols)
        want = qv.plain(name, x, qa[bits])
        err = (got.float() - want.float()).abs().max().item()
        scale = want.float().abs().max().item()
        # 1% of the output's magnitude: the same products summed in another
        # order in f32, then one bf16 rounding
        require(bool(torch.isfinite(got).all()) and err <= 1e-2 * scale,
                f"{label}: max|err| {err} > 1e-2 * {scale}")
        require(torch.equal(qv.variant(name, eye, qa[bits], cols),
                            weight[bits][idx].to(torch.bfloat16)),
                f"{label}: identity probe differs from the dequantized weight")
        note = ""
        if split is not None:
            require(torch.equal(qv.variant(name, x, qa[bits], cols), got),
                    f"{label}: two calls give different bits")
            note = (f"; split {split.splits} x {split.units_per_block} units, "
                    f"{split.tiles_per_block} tiles a block, two calls bitwise; "
                    f"tuning run {r['seconds'] * 1e3:.4f} ms")
        if split is not None and parent is not None:
            old = _variant_parent(parent, name, x, qa[bits], cols)
            old_err = (old.float() - want.float()).abs().max().item()
            require(bool(torch.isfinite(old).all()) and old_err <= 1e-2 * scale,
                    f"{label}: the earlier kernel's max|err| {old_err} > 1e-2 * {scale}")
            runs = {"earlier": lambda c: _variant_parent(parent, name, x, c, cols),
                    "new": lambda c: qv.variant(name, x, c, cols)}
            turns = [(k, tq.op_time(runs[k], rot[bits], reps, dev) * 1e3)
                     for k in ("earlier", "new", "new", "earlier")]
            pair = {k: sum(t for kk, t in turns if kk == k) / 2 for k in runs}
            earlier[f"{name} cols={cols}"] = pair
            note += (f"; in turns new {pair['new']:.4f} ms, earlier kernel {pair['earlier']:.4f} "
                     f"ms (err {old_err:.3g}), {pair['earlier'] / pair['new']:.2f}x")
        if name not in plain_ms:
            plain_ms[name] = tq.op_time(lambda c: qv.plain(name, x, c), rot[bits],
                                        max(2, reps // 4), dev, warmup=1) * 1e3
        b_ms, b_by = bound(nbytes[bits], 2.0 * b * d * f, PEAK_BF16_FLOPS)
        ms = r["seconds"] * 1e3
        rec = dict(name=f"{name}[cols={cols} B={b} {d}x{f} g={g}]", kernel=name,
                   max_abs_err=err, ms=ms, plain_ms=plain_ms[name], bound_ms=b_ms, bound_by=b_by,
                   library_ms=lib_ms[bits])
        if split is not None:  # blocks along D, a field of its own: the name stays the key
            rec["split"] = split.splits
        records.append(rec)
        log(f"  {label}: err {err:.3g} (tol {1e-2 * scale:.3g}), identity probe bitwise; "
            f"kernel {ms:.4f} ms plain {plain_ms[name]:.4f} ms cuBLAS-bf16 {lib_ms[bits]:.4f} ms "
            f"bound {b_ms:.4f} ms ({b_by}){note}")
    out = dict(launches=launches, cases={r["name"]: r["seconds"] * 1e3 for r in cases},
               earlier=earlier)
    log(f"  launches during the tuning run: {json.dumps(launches)}")
    del data, qa, rot, weight
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# model phases
# ---------------------------------------------------------------------------


def _quant_params(spec, seed: int, device, bits: int = 8):
    import torch

    from flexflow_tpu_torch.models import params as params_lib
    from flexflow_tpu_torch.quant import quantize_params

    gen = torch.Generator(device=device).manual_seed(seed)
    params = params_lib.init_params(spec, gen, torch.bfloat16, device)
    params = quantize_params(spec, params, bits=bits, group_size=128,
                             compute_dtype=torch.bfloat16)
    torch.cuda.empty_cache()
    return params


def _traces_bitwise(spec, params, tokens, positions, lengths) -> int:
    """``utils/debug_dump.forward_with_traces`` on the card against
    ``decoder.forward`` on the same inputs: the final logits bitwise equal
    (the traced run launches the same kernels), every trace finite.
    Returns the number of traces."""
    import torch

    from flexflow_tpu_torch.models import decoder
    from flexflow_tpu_torch.utils.debug_dump import forward_with_traces

    with torch.no_grad():
        want, _ = decoder.forward(spec, params, tokens, positions, lengths=lengths, flash=True)
    got, traces = forward_with_traces(spec, params, tokens, positions, lengths=lengths,
                                      flash=True)
    require(torch.equal(got, want), "forward_with_traces: logits differ from decoder.forward's")
    require(len(traces) == 5 * spec.num_layers + 2
            and all(bool(torch.isfinite(v.float()).all()) for v in traces.values()),
            f"forward_with_traces: {len(traces)} traces, or a trace not finite")
    log(f"  forward_with_traces: logits bitwise equal to decoder.forward's; {len(traces)} traces")
    return len(traces)


def crosscheck_phase(bits: int) -> dict:
    """2 layers at full 7B width, INT8 or INT4: GPU (kernels) vs CPU (plain)."""
    import numpy as np
    import torch

    from flexflow_tpu_torch.models import decoder
    from flexflow_tpu_torch.serving.engine import _params_to
    from flexflow_tpu_torch.specs import ModelSpec

    spec = ModelSpec(**{**LLAMA2_7B, "num_layers": 2})
    gpu = decoder.fuse_qkv_params(spec, _quant_params(spec, 1, torch.device("cuda"), bits))
    cpu = _params_to(gpu, torch.device("cpu"))
    rng = np.random.default_rng(4)
    lens = np.array([20, 13], np.int32)
    t = 32
    toks = np.zeros((2, t), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(3, spec.vocab_size, n)
    s_max, steps = 64, CROSSCHECK_STEPS
    caches, logits = {}, {}
    traced = None
    for name, dev, params in (("cuda", torch.device("cuda"), gpu), ("cpu", torch.device("cpu"), cpu)):
        cache = decoder.init_kv_cache(spec, 2, s_max, torch.bfloat16, dev)
        tk = torch.as_tensor(toks, device=dev)
        pos = torch.arange(t, dtype=torch.int32, device=dev)[None].expand(2, t)
        ln = torch.as_tensor(lens, device=dev)
        with torch.no_grad():
            lg, (k, v) = decoder.forward(spec, params, tk, pos, lengths=ln, flash=True,
                                         return_kv=True, logits_at=ln - 1)
        if name == "cuda" and bits == 8:
            traced = _traces_bitwise(spec, params, tk, pos, ln)
        decoder.commit_kv_windows(cache.k, cache.v, k.permute(0, 1, 3, 2, 4),
                                  v.permute(0, 1, 3, 2, 4), [0, 0])
        caches[name] = cache
        logits[name] = [lg.float().cpu()]
    # decode: the GPU's greedy tokens drive both sides (teacher forcing)
    cur = logits["cuda"][0].argmax(-1)
    for i in range(steps):
        for name, dev, params in (("cuda", torch.device("cuda"), gpu), ("cpu", torch.device("cpu"), cpu)):
            with torch.no_grad():
                lg, _ = decoder.forward_cached(
                    spec, params, cur[:, None].to(dev), caches[name],
                    torch.as_tensor(lens + i, device=dev), write_start=lens + i)
            logits[name].append(lg[:, 0].float().cpu())
        cur = logits["cuda"][-1].argmax(-1)
    g = torch.stack(logits["cuda"])
    c = torch.stack(logits["cpu"])
    require(bool(torch.isfinite(g).all()) and g.shape == (steps + 1, 2, spec.vocab_size),
            f"cross-check logits not finite or shaped {tuple(g.shape)}")
    err = (g - c).abs().max().item()
    scale = c.abs().max().item()
    # bf16 activations round at different points in the kernels' and the
    # plain versions' sums: allow 5% of the logits' magnitude
    tol = 5e-2 * scale
    require(err <= tol, f"cross-check logits: max|err| {err} > {tol}")
    top2 = torch.topk(c, 2, dim=-1).values
    margin = top2[..., 0] - top2[..., 1]
    agree = g.argmax(-1) == c.argmax(-1)
    # greedy tokens must agree wherever the CPU's top-2 margin exceeds the
    # observed logit error (closer ties are within rounding)
    decided = margin > 2 * err
    require(bool(agree[decided].all()),
            f"cross-check greedy tokens disagree at decided positions: {agree.tolist()}")
    out = dict(max_abs_err=err, tol=tol, tokens_equal=int(agree.sum()), tokens=int(agree.numel()),
               decided=int(decided.sum()), traces=traced)
    log(f"  cross-check INT{bits}: logits max|err| {err:.4g} (tol {tol:.4g}); greedy tokens equal "
        f"{out['tokens_equal']}/{out['tokens']} ({out['decided']} beyond the error margin)")
    del gpu, cpu, caches
    torch.cuda.empty_cache()
    return out


def _trace(runs, keep_all: bool = False) -> dict:
    """Each (name, fn, steps) run once to warm up, once timed on the host
    (dispatch, then wall after a sync) and once under ``torch.profiler``:
    device busy share and the device time of the top kernels (of every
    kernel, under ``kernels_ms``, with ``keep_all``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for name, fn, steps in runs:
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        t_host = time.perf_counter() - t0
        torch.cuda.synchronize()
        t_wall = time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        # device-side events only (kernels, memcpy/memset): CPU ops also
        # carry their kernels' time and would count it twice
        dev_us = {e.key: e.self_device_time_total for e in prof.key_averages()
                  if e.device_type.name == "CUDA" and e.self_device_time_total > 0}
        busy_ms = sum(dev_us.values()) / 1e3
        ranked = sorted(dev_us.items(), key=lambda kv: -kv[1])
        # the top 12, and every kernel of the port's below them
        top = ranked[:12] + [kv for kv in ranked[12:] if any(n in kv[0] for n in PORT_KERNELS)]
        out[name] = dict(host_dispatch_ms=t_host * 1e3, wall_ms=t_wall * 1e3,
                         per_step_ms=t_wall * 1e3 / steps, device_busy_ms=busy_ms,
                         device_busy_share=busy_ms / (t_wall * 1e3),
                         top_kernels_ms={k: v / 1e3 for k, v in top})
        if keep_all:
            out[name]["kernels_ms"] = {k: v / 1e3 for k, v in dev_us.items()}
        log(f"  {name}: host dispatch {t_host * 1e3:.2f} ms, wall {t_wall * 1e3:.2f} ms "
            f"({t_wall * 1e3 / steps:.3f} ms/step), device busy {busy_ms:.2f} ms "
            f"({100 * busy_ms / (t_wall * 1e3):.1f}%)")
        for k, v in top:
            log(f"    {v / 1e3:9.3f} ms  {k[:100]}")
    return out


def profile_phase(engine, prompts) -> dict:
    """Where a served step's time goes: one decode horizon (16 steps, 8
    slots) and one batched prefill, each timed on the host and traced."""
    import numpy as np

    from flexflow_tpu_torch.ops.sampling import SamplingConfig

    b = engine.max_requests
    greedy = SamplingConfig(np.zeros(b, np.float32), np.ones(b, np.float32),
                            np.zeros(b, np.int32))
    lens = np.array([len(p) for p in prompts], np.int32)
    toks = np.zeros(b, np.int32)
    return _trace([
        ("decode_horizon_16", lambda: engine.decode_horizon_async(lens, toks, 0, greedy, 16), 16),
        ("decode_horizon_16_uncaptured",
         lambda: engine.greedy_horizon_async(lens, toks, 16, replay=False), 16),
        ("prefill_8x1024",
         lambda: engine.prefill_batch_to_slots_async(prompts, list(range(b)), 0, greedy), 1),
    ])


def spec_profile(engine, prompts) -> dict:
    """Where a speculative iteration's time goes: one horizon of 8 fused
    iterations (draft tree, tree verify, walk, two commits) on 8 slots,
    replayed and then uncaptured."""
    lens = engine._h([len(p) for p in prompts])
    roots = engine._h([1] * len(prompts))
    return _trace([
        ("spec_horizon_8", lambda: engine.fused_step_n_async(lens, roots, 8), 8),
        ("spec_horizon_8_uncaptured",
         lambda: engine.greedy_horizon_async(lens, roots, 8, replay=False), 8),
    ])


def _launches(reset: bool = False) -> dict:
    """Every kernel wrapper's launch count (set to 0 first with ``reset``)."""
    from flexflow_tpu_torch.ops.kernels import decode_attention as da
    from flexflow_tpu_torch.ops.kernels import flash_prefill as fp
    from flexflow_tpu_torch.ops.kernels import qmm_variants as qv
    from flexflow_tpu_torch.ops.kernels import quant_matmul as qm

    if reset:
        qm.LAUNCHES = qm.LAUNCHES_INT4 = da.LAUNCHES = fp.LAUNCHES = 0
        da.SHARD_LAUNCHES = da.MERGE_LAUNCHES = 0
        qv.LAUNCHES.update(dict.fromkeys(qv.LAUNCHES, 0))
    return {"qmm_int8": qm.LAUNCHES, "qmm_int4": qm.LAUNCHES_INT4,
            "decode_attention": da.LAUNCHES, "decode_attention_shard": da.SHARD_LAUNCHES,
            "merge_states": da.MERGE_LAUNCHES, "flash_prefill": fp.LAUNCHES, **qv.LAUNCHES}


def _prompts(vocab_size: int):
    """The served runs' 8 prompts (random tokens from seed 5)."""
    import numpy as np

    rng = np.random.default_rng(5)
    return [rng.integers(3, vocab_size, n).tolist() for n in PROMPT_LENS]


def _served(rm, prompts, max_new: int, vocab_size: int, path: str, warm=None, adapters=None,
            session=None, replayed: bool = True):
    """Warm up on one short request (through ``warm``, a scheduler on the
    same engine, or ``rm``), set the launch counts to 0, serve ``prompts``
    (request i through LoRA adapter ``adapters[i]``; default none; with a
    finetuning ``session`` registered after the warm-up, which
    ``run_until_idle`` steps between scheduling iterations and drains) and
    read the counts. Every request must finish with ``max_new`` tokens from
    the vocabulary, and (``replayed``) every step must be a replay of one of
    the manager's engines' graphs. Returns (requests, stats)."""
    import numpy as np
    import torch

    from flexflow_tpu_torch.serving.request_manager import GenerationConfig

    (warm or rm).generate([prompts[-1]], GenerationConfig(max_new_tokens=4))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _launches(reset=True)
    if session is not None:
        rm.register_finetune(session)
    # an engine that captures nothing (CPU offload) has no graphs to count
    graphs = [e.graphs for e in getattr(rm, "engines", [rm.engine]) if e.graphs is not None]
    replays0 = sum(g.replays for g in graphs)
    steps0 = rm.total_decoding_steps
    t_start = time.monotonic()
    guids = [rm.register_request(p, GenerationConfig(max_new_tokens=max_new, adapter_id=a))
             for p, a in zip(prompts, adapters or [-1] * len(prompts))]
    rm.run_until_idle()
    reqs = [rm.get_request(g) for g in guids]
    torch.cuda.synchronize()
    t_end = time.monotonic()
    launches = _launches()
    for r in reqs:
        require(r.state == "COMPLETED" and len(r.output_tokens) == max_new,
                f"{path} request {r.guid}: state {r.state}, {len(r.output_tokens)} tokens")
        require(all(0 <= t < vocab_size for t in r.output_tokens),
                f"{path} request {r.guid}: token outside the vocabulary")
    # every greedy step (an incremental step, or a speculative iteration) of
    # the run was a replay of a captured graph
    replays = sum(g.replays for g in graphs) - replays0
    require(replays == (rm.total_decoding_steps - steps0 if replayed else 0),
            f"{path}: {replays} replays for {rm.total_decoding_steps - steps0} steps")
    first = max(r.profile.first_token_time for r in reqs)
    decode_tokens = sum(len(r.output_tokens) - 1 for r in reqs)
    return reqs, dict(
        requests=len(reqs), tokens=sum(len(r.output_tokens) for r in reqs),
        decode_tok_s=decode_tokens / (t_end - first),
        mean_ttft_ms=1e3 * float(np.mean([r.profile.ttft for r in reqs])),
        wall_s=t_end - t_start, steps=rm.total_decoding_steps - steps0,
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
        peak_reserved_gib=torch.cuda.max_memory_reserved() / 2**30, launches=launches,
        graphs=sum(len(g.graphs) for g in graphs), capture_ms=sum(g.capture_ms for g in graphs),
        replays=replays)


def _log_served(what: str, out: dict, card: str) -> None:
    log(f"  {what}: {out['requests']} requests, {out['tokens']} tokens in {out['wall_s']:.3f} s: "
        f"decode {out['decode_tok_s']:.1f} tok/s, mean TTFT {out['mean_ttft_ms']:.1f} ms, "
        f"{out['steps']} steps, peak memory {out['peak_mem_gib']:.2f} GiB allocated, "
        f"{out['peak_reserved_gib']:.2f} GiB reserved [{card}]")
    log(f"  {what}: {out['graphs']} CUDA graphs captured in {out['capture_ms']:.1f} ms "
        f"(warm-ups included), {out['replays']} replays in the run")
    log(f"  launches during the {what} run: {json.dumps(out['launches'])}")


def _replay_check(what: str, run, caches) -> None:
    """``run(replay)`` uncaptured, then replayed from the same state (the
    caches put back in between): its outputs and the caches it wrote must
    be bitwise equal."""
    import torch

    saved = [c.clone() for c in caches]
    want = [x.clone() for x in run(False)]
    torch.cuda.synchronize()
    want_caches = [c.clone() for c in caches]
    for c, x in zip(caches, saved):
        c.copy_(x)
    got = run(True)
    torch.cuda.synchronize()
    require(all(torch.equal(g, w) for g, w in zip(got, want)),
            f"{what}: replayed outputs differ from the uncaptured body's")
    require(all(torch.equal(c, w) for c, w in zip(caches, want_caches)),
            f"{what}: the replayed horizon's cache differs from the uncaptured body's")
    require(any(not torch.equal(c, x) for c, x in zip(caches, saved)),
            f"{what}: the horizon wrote nothing into the cache")
    log(f"  {what}: replayed outputs and cache bitwise equal to the uncaptured body's")
    del saved, want_caches
    torch.cuda.empty_cache()


def _llama_serving():
    """The served model: LLaMA-2-7B INT8 (group 128, random weights from seed
    0), 8 slots, max_seq_len 1024, decode_horizon 16, pipelined. Returns
    (spec, engine, request manager, the 8 prompts)."""
    import torch

    from flexflow_tpu_torch.serving.engine import InferenceEngine
    from flexflow_tpu_torch.serving.request_manager import RequestManager
    from flexflow_tpu_torch.specs import ModelSpec

    dev = torch.device("cuda")
    spec = ModelSpec(**LLAMA2_7B)
    t0 = time.perf_counter()
    params = _quant_params(spec, 0, dev)
    torch.cuda.synchronize()
    log(f"  weights: random LLaMA-2-7B INT8 in {time.perf_counter() - t0:.1f} s")
    engine = InferenceEngine(spec, params, max_requests_per_batch=8, max_seq_len=1024,
                             max_tokens_per_batch=0, cache_dtype=torch.bfloat16, device=dev)
    del params
    return spec, engine, RequestManager(engine, decode_horizon=16, pipelined=True), \
        _prompts(spec.vocab_size)


def serve_phase(card: str, with_profile: bool, hold: dict = None) -> dict:
    """The served run; with ``hold`` the model, its manager, the prompts and
    the run's requests and stats are kept there (the openai phase serves
    them again) instead of freed."""
    import numpy as np
    import torch

    spec, engine, rm, prompts = _llama_serving()
    try:
        reqs, out = _served(rm, prompts, 64, spec.vocab_size, "serve")
        _SERVED.update(tokens=[r.output_tokens for r in reqs], decode_tok_s=out["decode_tok_s"],
                       mean_ttft_ms=out["mean_ttft_ms"])
        lens = np.array([len(p) for p in prompts], np.int32)
        # not the served tokens, so the horizon writes other K/V than the run did
        toks = np.array([(r.output_tokens[0] + 1) % spec.vocab_size for r in reqs], np.int32)
        _replay_check("decode horizon (16 steps, 8 slots)",
                      lambda replay: [engine.greedy_horizon_async(lens, toks, 16, replay=replay)],
                      list(engine.cache))
        if with_profile:
            log("[profile] one decode horizon and one batched prefill of the served model")
            out["profile"] = profile_phase(engine, prompts)
    finally:
        if hold is None:
            rm.close()
    for k in ("qmm_int8", "decode_attention", "flash_prefill"):
        require(out["launches"][k] > 0, f"{k} was never launched while serving")
    out["card"] = card
    _log_served("served", out, card)
    if hold is not None:
        hold.update(spec=spec, rm=rm, prompts=prompts, reqs=reqs, out=out)
    del engine, rm
    torch.cuda.empty_cache()
    return out


class IdTokenizer:
    """The openai phase's stand-in tokenizer: text of decimal ids, "17 402 9"
    <-> [17, 402, 9] (no checkpoint, so no tokenizer, is in the repository).
    The decode of a prefix is a prefix of the decode of the whole."""

    def __call__(self, text: str, return_tensors=None) -> dict:
        return {"input_ids": [int(t) for t in text.split()]}

    def decode(self, ids, skip_special_tokens: bool = False) -> str:
        return " ".join(str(int(t)) for t in ids)


def _post(port: int, body, raw: bytes = None):
    """(status, JSON body) of a POST to the loopback server's /v1/completions."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/completions",
                                 data=raw if raw is not None else json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def _stream(port: int, body) -> tuple:
    """A streamed completion: (text deltas, finish reasons, the last event,
    seconds to the first non-empty delta)."""
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/completions",
                                 data=json.dumps(dict(body, stream=True)).encode(),
                                 headers={"Content-Type": "application/json"})
    t0, first, deltas, finishes, last = time.monotonic(), None, [], [], None
    with urllib.request.urlopen(req, timeout=600) as r:
        require(r.headers["Content-Type"].startswith("text/event-stream"),
                f"stream: content type {r.headers['Content-Type']}")
        for line in r:
            line = line.decode().strip()
            if not line.startswith("data: "):
                continue
            last = line[6:]
            if last == "[DONE]":
                continue
            choice = json.loads(last)["choices"][0]
            if choice["text"] and first is None:
                first = time.monotonic() - t0
            deltas.append(choice["text"])
            finishes.append(choice["finish_reason"])
    return deltas, finishes, last, first


def openai_phase(card: str, held: dict) -> dict:
    """The serve phase's model and manager (built here when that phase did
    not run) behind ``LLM.start_server()`` and the port's OpenAI handler on
    a loopback ``ThreadingHTTPServer``: one sampled request, then the served
    traffic from 8 client threads as token-id prompts, one streamed request
    and two bad ones. Every greedy step is a replay, each request's 64 tokens
    equal the in-process run's, and the server stops clean."""
    import threading
    from http.server import ThreadingHTTPServer

    import numpy as np
    import torch

    from flexflow_tpu_torch.inference.entrypoint import openai_server
    from flexflow_tpu_torch.serve import LLM
    from flexflow_tpu_torch.utils.profiling import per_op_profile

    if not held:
        spec, engine, rm, prompts = _llama_serving()
        reqs, base = _served(rm, prompts, 64, spec.vocab_size, "serve")
        del engine
    else:
        spec, rm, prompts, reqs, base = (held.pop(k) for k in
                                         ("spec", "rm", "prompts", "reqs", "out"))
    engine = rm.engine

    class ServedLLM(LLM):
        """The LLM API over an existing manager and tokenizer."""

        def __init__(self, rm, tokenizer):
            self.rm, self.tokenizer, self.output_file = rm, tokenizer, ""

    llm = ServedLLM(rm, IdTokenizer())
    llm.start_server()
    loop = rm._server_thread
    srv = ThreadingHTTPServer(("127.0.0.1", 0), openai_server.make_handler(llm, "llama-2-7b"))
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    port = srv.server_address[1]
    out = {}

    def idle():  # the loop holds no request and no horizon (read from this thread)
        t_end = time.monotonic() + 60
        while (rm._inflight_q or any(rm._slots)) and time.monotonic() < t_end:
            time.sleep(0.001)

    try:
        # 1. a sampled request first: its slot must not keep later greedy
        # horizons off the replay path once it retires
        code, body = _post(port, {"prompt": prompts[-1], "max_tokens": 8,
                                  "temperature": 0.8, "top_p": 0.95})
        require(code == 200 and body["usage"]["completion_tokens"] == 8,
                f"openai: the sampled request got {code} {body}")
        idle()
        require(not np.any(rm._temperature > 0), "openai: a retired slot kept its temperature")

        # 2. the served traffic over HTTP, one client thread a prompt
        _launches(reset=True)
        replays0, steps0 = engine.graphs.replays, rm.total_decoding_steps
        guid0 = max(rm._requests)
        answers = [None] * len(prompts)

        def client(i):
            answers[i] = _post(port, {"prompt": prompts[i], "max_tokens": 64,
                                      "temperature": 0})

        clients = [threading.Thread(target=client, args=(i,)) for i in range(len(prompts))]
        t_start = time.monotonic()
        for c in clients:
            c.start()
        for c in clients:
            c.join()
        t_end = time.monotonic()
        idle()
        launches = _launches()
        replays, steps = engine.graphs.replays - replays0, rm.total_decoding_steps - steps0
        http_reqs = [r for g, r in sorted(rm._requests.items()) if g > guid0]
        for i, (code, body) in enumerate(answers):
            require(code == 200, f"openai: request {i} got {code} {body}")
            got, want = [int(t) for t in body["choices"][0]["text"].split()], reqs[i].output_tokens
            at = next((j for j, (a, b) in enumerate(zip(got, want)) if a != b),
                      min(len(got), len(want)))
            require(got == want, f"openai: request {i} (prompt {len(prompts[i])}): tokens differ "
                                 f"from the in-process run's from position {at}")
            require(body["usage"]["completion_tokens"] == 64
                    and body["usage"]["prompt_tokens"] == len(prompts[i]),
                    f"openai: request {i} usage {body['usage']}")
        require(replays == steps > 0, f"openai: {replays} replays for {steps} steps")
        for k in ("qmm_int8", "decode_attention", "flash_prefill"):
            require(launches[k] > 0, f"openai: {k} was never launched while serving over HTTP")
        first = max(r.profile.first_token_time for r in http_reqs)
        out.update(
            requests=len(http_reqs), tokens=sum(len(r.output_tokens) for r in http_reqs),
            # as _served: from the last first token to the host's end of the run
            decode_tok_s=sum(len(r.output_tokens) - 1 for r in http_reqs) / (t_end - first),
            mean_ttft_ms=1e3 * float(np.mean([r.profile.ttft for r in http_reqs])),
            wall_s=t_end - t_start, steps=steps, replays=replays, launches=launches,
            admissions=len({r.profile.first_token_time for r in http_reqs}))  # one a prefill

        # 3. the longest prompt streamed: its deltas join to step 2's text
        deltas, finishes, last, first_s = _stream(port, {"prompt": prompts[0], "max_tokens": 64,
                                                        "temperature": 0})
        require("".join(deltas) == answers[0][1]["choices"][0]["text"],
                "openai: the streamed text differs from the completion's")
        require(last == "[DONE]" and finishes[-1] == "stop",
                f"openai: the stream ended with {finishes[-1:]} and {last!r}")
        out.update(stream_chunks=len([d for d in deltas if d]), stream_first_ms=1e3 * first_s)
        idle()

        # 4. refusals: an oversize prompt at registration, and bad JSON
        code, body = _post(port, {"prompt": [5] * 1024, "max_tokens": 4})
        require(code == 400 and "max_seq_len" in body["error"]["message"],
                f"openai: a 1024-token prompt got {code} {body}")
        require(loop.is_alive(), "openai: the serving loop died on an oversize prompt")
        code, body = _post(port, None, raw=b"{not json")
        require(code == 400, f"openai: bad JSON got {code} {body}")
    finally:
        llm.stop_server()
        srv.shutdown()
        srv.server_close()
    # 5. a clean stop
    require(rm._server_thread is None and not loop.is_alive(), "openai: the loop did not join")
    running = [g for g, r in rm._requests.items() if r.state == "RUNNING"]
    require(not running, f"openai: requests left RUNNING: {running}")
    rows = per_op_profile(spec, engine.params, batch=1, seq=32)
    for line in rows:
        log(f"  {line} [{card}]")
    rm.close()
    out.update(card=card, per_op=rows, base=dict(decode_tok_s=base["decode_tok_s"],
                                                 mean_ttft_ms=base["mean_ttft_ms"]))
    log(f"  openai: {out['requests']} requests over HTTP, {out['tokens']} tokens in "
        f"{out['wall_s']:.3f} s, {out['admissions']} admissions: decode "
        f"{out['decode_tok_s']:.1f} tok/s, mean TTFT {out['mean_ttft_ms']:.1f} ms; in-process "
        f"run of this call: decode {base['decode_tok_s']:.1f} tok/s, mean TTFT "
        f"{base['mean_ttft_ms']:.1f} ms [{card}]")
    log(f"  openai: {out['steps']} steps, {out['replays']} replays; launches "
        f"{json.dumps(out['launches'])}")
    log(f"  openai: stream of the {len(prompts[0])}-token prompt: first non-empty chunk after "
        f"{out['stream_first_ms']:.1f} ms, {out['stream_chunks']} chunks [{card}]")
    del engine, rm, llm
    torch.cuda.empty_cache()
    return out


# a 160M-class draft at the 7B head_dim (the pair construction needs one
# head_dim), the widths of bench_spec.py's DRAFT_7B
DRAFT_160M = dict(LLAMA2_7B, hidden_size=768, num_layers=12, num_heads=6, num_kv_heads=6,
                  intermediate_size=3072)
PREFIX = 20  # tokens of every request that must equal incremental decoding's
# the merged run of two drafts (stepwise, its T = 19 tree form): new tokens a
# request, cut from the serve traffic's 64 for the run's time (PREFIX still fits)
SPEC_MERGED_NEW = 24


DRAFT_B_NOISE = 0.05  # draft B: draft A plus seeded noise of this RMS relative to each tensor's
CATCHUP_REL = 5e-2  # a caught-up draft cache's rel L2 against a fresh prefill, bf16


def _prefix_equal(what: str, got_reqs, want_reqs) -> list:
    """Per request, the tokens of ``got_reqs`` equal to ``want_reqs``'s before
    the first difference; each must reach ``PREFIX``."""
    same = []
    for g, w in zip(got_reqs, want_reqs):
        a, b = g.output_tokens, w.output_tokens
        n = next((j for j in range(len(a)) if a[j] != b[j]), len(a))
        same.append(n)
        if n < PREFIX:
            log(f"  {what} request {g.guid}: first difference at token {n}: {a[:n + 2]} "
                f"against incremental {b[:n + 2]}")
    log(f"  {what}: tokens equal to incremental before the first difference, per request: "
        f"{same}")
    require(min(same) >= PREFIX,
            f"{what} output differs from incremental within the first {PREFIX} tokens")
    return same


def _ptrs(tree) -> list:
    """Every tensor's data_ptr in a parameter tree, in key order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _ptrs(tree[k])]
    if hasattr(tree, "q"):
        return [x.data_ptr() for x in (tree.q, tree.scale, tree.offset) if x is not None]
    return [tree.data_ptr()]


def _shares_verifier(engines) -> bool:
    first = engines[0]
    return all(_ptrs(e.llm_params) == _ptrs(first.llm_params)
               and e.llm_cache.k.data_ptr() == first.llm_cache.k.data_ptr()
               and e.llm_cache.v.data_ptr() == first.llm_cache.v.data_ptr() for e in engines)


def _snapshot_drafts_at_retire(rm) -> dict:
    """Wrap ``rm._retire``: before a slot is freed, copy each draft cache's
    rows below that draft's committed length (a later catch-up writes junk
    into free slots). Returns {guid: [(length, k rows, v rows) per draft]}."""
    snaps = {}
    retire = rm._retire

    def snapshot_then_retire(slot):
        req = rm._slots[slot]
        snaps[req.guid] = [(int(lens[slot]), e.ssm_cache.k[:, slot, :, :int(lens[slot])].clone(),
                            e.ssm_cache.v[:, slot, :, :int(lens[slot])].clone())
                           for e, lens in zip(rm.engines, rm._ssm_lens)]
        retire(slot)

    rm._retire = snapshot_then_retire
    return snaps


def _catchup_rule(engines, reqs, snaps) -> float:
    """Each draft's committed rows at retirement against a fresh prefill of
    the request's history through the same draft (flash prefill, bf16):
    relative L2 over K and V within ``CATCHUP_REL``. Returns the largest."""
    import torch

    from flexflow_tpu_torch.models import decoder

    worst, rows = 0.0, 0
    for req in reqs:
        for i, (n, k, v) in enumerate(snaps[req.guid]):
            if n == 0:
                continue
            e = engines[i]
            toks = torch.tensor([req.tokens[:n]], device=e.device)
            pos = torch.arange(n, dtype=torch.int32, device=e.device)[None]
            with torch.no_grad():
                _, (fk, fv) = decoder.forward(e.ssm_spec, e.ssm_params, toks, pos, flash=True,
                                              return_kv=True)
            want = torch.cat([fk[:, 0].permute(0, 2, 1, 3).float(),
                              fv[:, 0].permute(0, 2, 1, 3).float()])
            got = torch.cat([k.float(), v.float()])
            rel = ((got - want).norm() / want.norm()).item()
            require(rel <= CATCHUP_REL, f"draft {i} cache of request {req.guid}: rel L2 {rel:.3g} "
                                        f"against a fresh prefill of {n} tokens > {CATCHUP_REL}")
            worst, rows = max(worst, rel), rows + n
    require(rows > 0, "no draft cache rows were checked")
    return worst


def _noisy(params, gen, rel: float):
    """``params`` plus seeded normal noise of RMS ``rel`` x each tensor's RMS."""
    import torch

    if isinstance(params, dict):
        return {k: _noisy(params[k], gen, rel) for k in sorted(params)}
    noise = torch.randn(params.shape, generator=gen, device=params.device)
    return (params.float() + noise * rel * params.float().pow(2).mean().sqrt()).to(params.dtype)


def two_draft_runs(engine, dspec, dparams, prompts, card) -> dict:
    """Draft B (draft A's architecture and weights plus ``DRAFT_B_NOISE``
    noise, tree width 1 and depth 6) on ``engine``'s verifier tensors and
    cache, beside ``engine`` (draft A): the prompts served by rotation
    (``MultiSSMSpecManager``, fused: every iteration a replay of one engine's
    graph) and then merged (stepwise: 1 + 12 + 6 = 19 nodes a slot;
    ``SPEC_MERGED_NEW`` tokens a request). Returns
    {mode: (requests, stats)}."""
    import torch

    from flexflow_tpu_torch.serving.spec_manager import MultiSSMSpecManager
    from flexflow_tpu_torch.serving.speculative import SpecEngine
    from flexflow_tpu_torch.utils.profiling import StepTimer

    dev = engine.device
    dparams_b = _noisy(dparams, torch.Generator(device=dev).manual_seed(1), DRAFT_B_NOISE)
    engine_b = SpecEngine(engine.llm_spec, engine.llm_params, dspec, dparams_b, beam_width=1,
                          beam_depth=6, max_requests_per_batch=engine.max_requests,
                          max_seq_len=engine.max_seq_len, cache_dtype=torch.bfloat16,
                          device=dev, llm_cache=engine.llm_cache)
    engines = [engine, engine_b]
    require(_shares_verifier(engines),
            "the two drafts' engines do not share the verifier's tensors and cache")
    log(f"  draft B: draft A + noise at {DRAFT_B_NOISE} of each tensor's RMS (seed 1), width 1 "
        f"depth 6; the engines share the verifier's {len(_ptrs(engine.llm_params))} tensors and "
        f"its cache (data_ptr)")
    runs = {}
    for mode in ("rotation", "merged"):
        merged = mode == "merged"
        managers = [MultiSSMSpecManager(engines, merged=merged, fused=not merged)
                    for _ in range(2)]
        managers[0]._rr = 1  # the warm-up's first turn is draft B's: its graphs are captured
        rm = managers[1]
        rm.timer = StepTimer()  # host wall time per scheduling phase
        snaps = _snapshot_drafts_at_retire(rm)
        reqs, out = _served(rm, prompts, SPEC_MERGED_NEW if merged else 64,
                            engine.llm_spec.vocab_size, f"{mode} of two drafts",
                            warm=managers[0], replayed=not merged)
        del rm._retire  # the snapshot wrapper's reference cycle would keep the engines alive
        out["phases_ms"] = {k: 1e3 * v for k, v in rm.timer.totals.items()}
        out.update(card=card, mean_verified_tokens_per_step=rm.mean_verified_tokens_per_step,
                   tree=rm._merged_t if merged else [e.tree for e in engines])
        out["catchup_max_rel_l2"] = _catchup_rule(engines, reqs, snaps)
        _log_served(f"{mode} of two drafts", out, card)
        log(f"  {mode}: mean verified tokens per step {out['mean_verified_tokens_per_step']:.3f} "
            f"(trees {out['tree']}); draft caches caught up: largest rel L2 against a fresh "
            f"prefill {out['catchup_max_rel_l2']:.3g} (limit {CATCHUP_REL}) [{card}]")
        runs[mode] = (reqs, out)
        del managers, rm, snaps
    require(_shares_verifier(engines), "the engines stopped sharing the verifier")
    del engine_b, engines, dparams_b
    torch.cuda.empty_cache()
    return runs


_SPEC_SERVED: dict = {}  # the spec phase's one-device tokens and decode tok/s, for the pp phase


def _spec_pair(dev):
    """The spec phase's pair: the 160M-class bf16 draft (seed 0) and the
    LLaMA-2-7B INT4 verifier (group 128) block-embedding it, whole.
    Returns (draft spec, verifier spec, draft params, verifier params)."""
    import torch

    from flexflow_tpu_torch.models import params as params_lib
    from flexflow_tpu_torch.specs import ModelSpec
    from flexflow_tpu_torch.utils.spec_pair import embed_draft_in_verifier

    dspec, vspec = ModelSpec(**DRAFT_160M), ModelSpec(**LLAMA2_7B)
    dparams = params_lib.init_params(dspec, torch.Generator(device=dev).manual_seed(0),
                                     torch.bfloat16, dev)
    vparams = embed_draft_in_verifier(dspec, dparams, vspec, bits=4, group_size=128,
                                      dtype=torch.bfloat16, device=dev)
    return dspec, vspec, dparams, vparams


def _spec_managers(engine) -> list:
    """Two fused, pipelined managers on ``engine`` at ``LLM.compile``'s
    clamp of the horizon (the speculation margin stays within a quarter of
    the context): a warm-up one and the measured one."""
    from flexflow_tpu_torch.config import config as ffconfig
    from flexflow_tpu_torch.serving.spec_manager import SpecRequestManager
    from flexflow_tpu_torch.serving.speculative import tree_size

    horizon = max(1, min(ffconfig.spec_horizon,
                         engine.max_seq_len // (4 * (tree_size(engine.width, engine.depth) + 1))))
    return [SpecRequestManager(engine, fused=True, spec_horizon=horizon, pipelined=horizon > 1,
                               pipeline_depth=ffconfig.pipeline_depth) for _ in range(2)]


def spec_phase(card: str, with_profile: bool) -> dict:
    """Tree-speculative serving of LLaMA-2-7B INT4 with a 160M-class bf16
    draft that the verifier block-embeds (``utils/spec_pair``), through
    ``SpecEngine`` + the fused, pipelined ``SpecRequestManager``; then a
    second draft beside it, rotated and merged (``two_draft_runs``); and the
    incremental INT4 run of the same verifier they must all agree with."""
    import torch

    from flexflow_tpu_torch.serving.engine import InferenceEngine
    from flexflow_tpu_torch.serving.request_manager import RequestManager
    from flexflow_tpu_torch.serving.speculative import SpecEngine

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    dspec, vspec, dparams, vparams = _spec_pair(dev)
    torch.cuda.synchronize()
    log(f"  weights: 160M-class bf16 draft and the LLaMA-2-7B INT4 verifier embedding it "
        f"in {time.perf_counter() - t0:.1f} s")
    width, depth, seq = 3, 4, 1024
    prompts = _prompts(vspec.vocab_size)
    engine = SpecEngine(vspec, vparams, dspec, dparams, beam_width=width, beam_depth=depth,
                        max_requests_per_batch=8, max_seq_len=seq, cache_dtype=torch.bfloat16,
                        device=dev)
    managers = _spec_managers(engine)  # a warm-up one, so the measured one counts only its run
    rm = managers[1]
    horizon = rm.spec_horizon
    spec_reqs, out = _served(rm, prompts, 64, vspec.vocab_size, "spec", warm=managers[0])
    out.update(spec_horizon=horizon, pipeline_depth=rm.pipeline_depth,
               mean_verified_tokens_per_step=rm.mean_verified_tokens_per_step)
    _SPEC_SERVED.update(tokens=[r.output_tokens for r in spec_reqs],
                        decode_tok_s=out["decode_tok_s"],
                        verified=rm.mean_verified_tokens_per_step)
    lens = engine._h([len(p) for p in prompts])
    roots = engine._h([(r.output_tokens[0] + 1) % vspec.vocab_size for r in spec_reqs])
    _replay_check(f"speculative horizon ({horizon} iterations, 8 slots)",
                  lambda replay: engine.greedy_horizon_async(lens, roots, horizon, replay=replay),
                  [*engine.llm_cache, *engine.ssm_cache])
    if with_profile:
        log("[profile] one 8-iteration horizon of the speculative engine")
        out["profile"] = spec_profile(engine, prompts)
    del rm, managers
    two = two_draft_runs(engine, dspec, dparams, prompts, card)
    del engine
    torch.cuda.empty_cache()

    engine = InferenceEngine(vspec, vparams, max_requests_per_batch=8, max_seq_len=seq,
                             max_tokens_per_batch=0, cache_dtype=torch.bfloat16, device=dev)
    rm = RequestManager(engine, decode_horizon=16, pipelined=True)
    try:
        incr_reqs, incr = _served(rm, prompts, 64, vspec.vocab_size, "incremental INT4")
    finally:
        rm.close()
    del engine, rm, vparams, dparams
    torch.cuda.empty_cache()

    out["card"] = card
    out["incremental"] = incr
    _log_served("speculative", out, card)
    log(f"  mean verified tokens per step {out['mean_verified_tokens_per_step']:.3f} "
        f"(spec_horizon {horizon}, width {width}, depth {depth}) [{card}]")
    _log_served("incremental INT4", incr, card)
    out["tokens_equal_to_incremental"] = _prefix_equal("one draft", spec_reqs, incr_reqs)
    for mode, (reqs, stats) in two.items():
        stats["tokens_equal_to_incremental"] = _prefix_equal(f"{mode} of two drafts", reqs,
                                                             incr_reqs)
        out[mode] = stats
        log(f"  {mode} of two drafts against one draft: decode {stats['decode_tok_s']:.1f} "
            f"against {out['decode_tok_s']:.1f} tok/s, mean TTFT {stats['mean_ttft_ms']:.1f} "
            f"against {out['mean_ttft_ms']:.1f} ms, peak {stats['peak_mem_gib']:.2f} against "
            f"{out['peak_mem_gib']:.2f} GiB, verified/step "
            f"{stats['mean_verified_tokens_per_step']:.3f} against "
            f"{out['mean_verified_tokens_per_step']:.3f} [{card}]")
    for k in ("qmm_int4", "decode_attention", "flash_prefill"):
        require(out["launches"][k] > 0, f"{k} was never launched while serving speculatively")
        for mode in two:
            require(out[mode]["launches"][k] > 0, f"{k} was never launched in the {mode} run")
    require(out["mean_verified_tokens_per_step"] > 1,
            f"mean verified tokens per step {out['mean_verified_tokens_per_step']} <= 1")
    return out


# ---------------------------------------------------------------------------
# Mixtral-8x7B (MoE)
# ---------------------------------------------------------------------------


def mixtral_spec(num_layers=None, impl: str = "dense"):
    """Mixtral-8x7B's spec as ``from_hf_config`` gives it (the dense MoE
    form), with ``num_layers`` and the MoE form ``impl`` if given."""
    from flexflow_tpu_torch.specs import from_hf_config

    spec = from_hf_config(MIXTRAL_8X7B)
    return dataclasses.replace(spec, num_layers=num_layers or spec.num_layers,
                               moe=dataclasses.replace(spec.moe, impl=impl))


def moe_launches_per_forward(spec) -> int:
    """qmm_int8 calls in one forward of a MoE model with fused wq|wk|wv:
    wqkv, wo and 3 per expert a layer, and the lm_head."""
    return spec.num_layers * (2 + 3 * spec.moe.num_experts) + 1


class RoutingLog:
    """Records every ``ops/moe.route_topk`` call's routing probabilities
    and chosen experts (on the host) while active."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        import torch

        from flexflow_tpu_torch.ops import moe

        self._orig = orig = moe.route_topk

        def route(logits, top_k):
            w, i = orig(logits, top_k)
            self.calls.append((torch.softmax(logits.float(), dim=-1).cpu(), i.cpu()))
            return w, i

        moe.route_topk = route
        return self

    def __exit__(self, *exc):
        from flexflow_tpu_torch.ops import moe

        moe.route_topk = self._orig


def routing_rule(gpu_calls, cpu_calls, rows, n_layers: int) -> dict:
    """The routing comparison of two runs' ``RoutingLog``s. ``rows[c]`` maps
    call c's row indices to token ids (None: a padding row, skipped);
    calls go layer by layer. A token is clean at a layer if its top-k set
    agreed at every earlier layer. Per layer, the observed probability
    error is the largest |p_gpu - p_cpu| over clean tokens whose sets agree
    there; a token is excluded where it is clean and the CPU's 2nd-vs-3rd
    probability margin is within twice that error. Every token not
    excluded must agree at every layer. Returns the excluded and the
    flipped token ids (a flipped token's sets differ at some layer) and the
    observed errors."""
    import torch

    layers = [[] for _ in range(n_layers)]  # per layer: (token, p_gpu, p_cpu, agree)
    for c, ((pg, ig), (pc, ic)) in enumerate(zip(gpu_calls, cpu_calls)):
        agree = (ig.sort(-1).values == ic.sort(-1).values).all(-1)
        for r, tok in enumerate(rows[c // n_layers]):
            if tok is not None:
                layers[c % n_layers].append((tok, pg[r], pc[r], bool(agree[r])))
    clean = {tok for tok, *_ in layers[0]}
    excluded, flipped, errs = set(), set(), []
    for per in layers:
        ok = [(t, g, c) for t, g, c, a in per if t in clean and a]
        err = max(((g - c).abs().max().item() for _, g, c in ok), default=0.0)
        errs.append(err)
        for tok, g, c, a in per:
            if tok not in clean:
                continue
            top3 = torch.topk(c, 3).values
            if top3[1] - top3[2] <= 2 * err:
                excluded.add(tok)
            elif not a:
                raise PhaseError(f"routing differs for token {tok} with a 2nd-vs-3rd margin "
                                 f"{(top3[1] - top3[2]).item():.3g} > 2 x the observed error "
                                 f"{err:.3g}")
            if not a:
                flipped.add(tok)
        clean -= {t for t, _, _, a in per if not a}
    return dict(routed_tokens=len(layers[0]), excluded=sorted(excluded), flipped=sorted(flipped),
                prob_err_per_layer=errs)


def logits_rule(g, c, keep, what: str) -> dict:
    """The cross-check's logit rule on rows ``keep``: max |err| within 5% of
    the CPU logits' magnitude, and greedy tokens equal wherever the CPU's
    top-2 margin exceeds twice the observed error."""
    import torch

    g, c = g[keep], c[keep]
    require(g.numel() > 0, f"{what}: every logits row left out")
    require(bool(torch.isfinite(g).all()), f"{what}: logits not finite")
    err = (g - c).abs().max().item()
    scale = c.abs().max().item()
    tol = 5e-2 * scale
    require(err <= tol, f"{what}: logits max|err| {err} > {tol}")
    top2 = torch.topk(c, 2, dim=-1).values
    decided = (top2[..., 0] - top2[..., 1]) > 2 * err
    agree = g.argmax(-1) == c.argmax(-1)
    require(bool(agree[decided].all()),
            f"{what}: greedy tokens disagree at decided positions: {agree.tolist()}")
    return dict(max_abs_err=err, tol=tol, tokens_equal=int(agree.sum()),
                tokens=int(agree.numel()), decided=int(decided.sum()))


def crosscheck_mixtral(dev=None, spec=None, steps: int = MIXTRAL_CHECK_STEPS) -> dict:
    """2 layers at full Mixtral-8x7B width, INT8 group 128 (streaming init,
    seed 1): a prefill of 4 requests and ``steps`` teacher-forced decode
    steps through the kernels on ``dev`` against the plain versions on the
    CPU, holding both the logits and every token's routing
    (``routing_rule``)."""
    import numpy as np
    import torch

    from flexflow_tpu_torch.models import decoder
    from flexflow_tpu_torch.models import params as params_lib
    from flexflow_tpu_torch.serving.engine import _params_to

    dev = dev or torch.device("cuda")
    spec = spec or mixtral_spec(num_layers=2)
    gpu = decoder.fuse_qkv_params(spec, params_lib.init_quantized_params(
        spec, torch.Generator(device=dev).manual_seed(1), bits=8, group_size=128,
        dtype=torch.bfloat16, device=dev))
    cpu = _params_to(gpu, torch.device("cpu"))
    t0 = time.perf_counter()
    rng = np.random.default_rng(4)
    lens = np.array([20, 13, 27, 9], np.int32)
    nb, t, s_max = len(lens), 32, 64
    toks = np.zeros((nb, t), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(3, spec.vocab_size, n)
    sides = (("gpu", dev, gpu), ("cpu", torch.device("cpu"), cpu))
    caches, logits, routes = {}, {}, {}
    for name, d, params in sides:
        cache = decoder.init_kv_cache(spec, nb, s_max, torch.bfloat16, d)
        ln = torch.as_tensor(lens, device=d)
        with torch.no_grad(), RoutingLog() as rec:
            lg, (k, v) = decoder.forward(
                spec, params, torch.as_tensor(toks, device=d),
                torch.arange(t, dtype=torch.int32, device=d)[None].expand(nb, t), lengths=ln,
                flash=True, return_kv=True, logits_at=ln - 1)
        decoder.commit_kv_windows(cache.k, cache.v, k.permute(0, 1, 3, 2, 4),
                                  v.permute(0, 1, 3, 2, 4), [0] * nb)
        caches[name], logits[name], routes[name] = cache, [lg.float().cpu()], rec.calls
    # token ids: (request, position); the dense form routes the padding too
    rows = [[(b, p) if p < lens[b] else None for b in range(nb) for p in range(t)]]
    cur = logits["gpu"][0].argmax(-1)  # the GPU's greedy tokens drive both sides
    for i in range(steps):
        for name, d, params in sides:
            with torch.no_grad(), RoutingLog() as rec:
                lg, _ = decoder.forward_cached(
                    spec, params, cur[:, None].to(d), caches[name],
                    torch.as_tensor(lens + i, device=d), write_start=lens + i)
            logits[name].append(lg[:, 0].float().cpu())
            routes[name] += rec.calls
        rows.append([(b, int(lens[b]) + i) for b in range(nb)])
        cur = logits["gpu"][-1].argmax(-1)
    routing = routing_rule(routes["gpu"], routes["cpu"], rows, spec.num_layers)
    log(f"  cross-check Mixtral-width INT8 (2 layers), routing of {routing['routed_tokens']} "
        f"tokens x {spec.num_layers} layers: {len(routing['flipped'])} tokens with a differing "
        f"top-2 set, {len(routing['excluded'])} near-ties excluded from the routing check, "
        f"probability error per layer {[f'{e:.3g}' for e in routing['prob_err_per_layer']]}; "
        f"flipped (request, position): {routing['flipped']}")
    g, c = torch.stack(logits["gpu"]), torch.stack(logits["cpu"])  # [steps + 1, B, V]
    require(g.shape == (steps + 1, nb, spec.vocab_size), f"logits shaped {tuple(g.shape)}")
    # a flipped token's FFN output differs wholesale, and the logits at its
    # position and past it (through attention) follow: those rows are left out
    positions = [[int(lens[b]) - 1 + i for b in range(nb)] for i in range(steps + 1)]
    keep = torch.tensor([[not any(b == fb and p <= pos for fb, p in routing["flipped"])
                          for b, pos in enumerate(row)] for row in positions])
    out = logits_rule(g, c, keep, "mixtral cross-check")
    out.update(routing, excluded=len(routing["excluded"]), flipped=len(routing["flipped"]),
               logit_rows_excluded=int((~keep).sum()), seconds=time.perf_counter() - t0)
    log(f"  cross-check logits: max|err| {out['max_abs_err']:.4g} (tol {out['tol']:.4g}); greedy "
        f"tokens equal {out['tokens_equal']}/{out['tokens']} ({out['decided']} beyond the error "
        f"margin); {out['logit_rows_excluded']} of {keep.numel()} logit rows left out after a "
        f"flipped token; {out['seconds']:.1f} s")
    del gpu, cpu, caches
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def prefill_forms(engine, prompts) -> dict:
    """One batched prefill of ``prompts`` (the served 8 x 1024 bucket)
    through ``decoder.forward`` with the dense and with the ragged MoE form
    on the engine's weights, each timed on the host clock around a
    synchronised call (the ragged form run once before, untimed); their
    logits at each request's last prompt position must agree by the
    cross-check's rule."""
    import numpy as np
    import torch

    from flexflow_tpu_torch.models import decoder

    dev = engine.device
    b = len(prompts)
    bucket = max(engine.prefill_bucket(len(p)) for p in prompts)
    toks = np.zeros((b, bucket), np.int32)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    tok = torch.as_tensor(toks, device=dev)
    lens = torch.tensor([len(p) for p in prompts], dtype=torch.int32, device=dev)
    pos = torch.arange(bucket, dtype=torch.int32, device=dev)[None].expand(b, bucket)
    specs = {"dense": engine.spec,
             "ragged": dataclasses.replace(engine.spec, moe=dataclasses.replace(
                 engine.spec.moe, impl="ragged"))}

    def run(form):
        with torch.no_grad():
            return decoder.forward(specs[form], engine.params, tok, pos, lengths=lens,
                                   flash=True, logits_at=lens - 1)[0].float()

    run("ragged")
    out, ms = {}, {}
    for form in ("dense", "ragged"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[form] = run(form)
        torch.cuda.synchronize()
        ms[form] = (time.perf_counter() - t0) * 1e3
    rule = logits_rule(out["ragged"].cpu(), out["dense"].cpu(), slice(None),
                       "ragged vs dense prefill")
    rule.update(dense_ms=ms["dense"], ragged_ms=ms["ragged"], bucket=[b, bucket],
                bitwise_equal=bool(torch.equal(out["dense"], out["ragged"])))
    log(f"  batched prefill {b}x{bucket}: dense {ms['dense']:.1f} ms, ragged {ms['ragged']:.1f} ms "
        f"(host clock, synchronised); logits at the last prompt positions max|err| "
        f"{rule['max_abs_err']:.4g} (tol {rule['tol']:.4g}), bitwise equal: {rule['bitwise_equal']}")
    return rule


def mixtral_phase(card: str, with_profile: bool) -> dict:
    """Mixtral-8x7B INT8 at full width and depth: the cross-check, the
    streaming init, the served run with its predicted launch counts, one
    replayed horizon against the uncaptured body, and the dense and ragged
    prefills."""
    import numpy as np
    import torch

    from flexflow_tpu_torch.models import params as params_lib
    from flexflow_tpu_torch.serving.engine import InferenceEngine
    from flexflow_tpu_torch.serving.request_manager import RequestManager

    out = {"crosscheck": crosscheck_mixtral()}
    dev = torch.device("cuda")
    spec = mixtral_spec()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = params_lib.init_quantized_params(
        spec, torch.Generator(device=dev).manual_seed(0), bits=8, group_size=128,
        dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t0
    out["weights_gib"] = torch.cuda.memory_allocated() / 2**30
    out["init_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    log(f"  weights: random Mixtral-8x7B INT8 (group 128), streaming init in {out['init_s']:.1f} s: "
        f"{out['weights_gib']:.2f} GiB held, {out['init_peak_gib']:.2f} GiB peak allocated [{card}]")
    engine = InferenceEngine(spec, params, max_requests_per_batch=8, max_seq_len=1024,
                             max_tokens_per_batch=0, cache_dtype=torch.bfloat16, device=dev)
    del params
    rm = RequestManager(engine, decode_horizon=16, pipelined=True)
    prompts = _prompts(spec.vocab_size)
    try:
        reqs, served = _served(rm, prompts, 64, spec.vocab_size, "mixtral")
        out.update(served)
        n, steps = spec.num_layers, served["replays"]
        prefills = served["launches"]["flash_prefill"] // n
        want = {"qmm_int8": moe_launches_per_forward(spec) * (steps + prefills),
                "decode_attention": n * steps, "flash_prefill": n * prefills}
        got = {k: served["launches"][k] for k in want}
        require(prefills >= 1 and got == want,
                f"mixtral launches {got} != the predicted {want} ({steps} decode steps, "
                f"{prefills} prefills)")
        out["predicted_launches"] = want
        lens = np.array([len(p) for p in prompts], np.int32)
        toks = np.array([(r.output_tokens[0] + 1) % spec.vocab_size for r in reqs], np.int32)
        _replay_check("mixtral decode horizon (16 steps, 8 slots)",
                      lambda replay: [engine.greedy_horizon_async(lens, toks, 16, replay=replay)],
                      list(engine.cache))
        out["prefill_forms"] = prefill_forms(engine, prompts)
        if with_profile:
            log("[profile] one decode horizon and one batched prefill of Mixtral-8x7B INT8")
            out["profile"] = profile_phase(engine, prompts)
    finally:
        rm.close()
    out["card"] = card
    _log_served("mixtral", out, card)
    log(f"  launches as predicted: {moe_launches_per_forward(spec)} qmm_int8 a forward, "
        f"{spec.num_layers} decode_attention a decode step, {spec.num_layers} flash_prefill a "
        f"prefill [{card}]")
    del rm
    out["spec"] = mixtral_spec_run(engine, reqs, prompts, out, card)
    del engine
    torch.cuda.empty_cache()
    return out


MIXTRAL_SPEC_NEW = 32  # new tokens a request (cut from the serve traffic's 64 for the run's time)
MIXTRAL_SPEC_PEAK_GIB = 4.0  # the speculative run's peak memory over the incremental run's


def mixtral_spec_run(engine, incr_reqs, prompts, incr: dict, card: str) -> dict:
    """Mixtral-8x7B INT8 as the verifier under ``SpecEngine`` (dense MoE
    form, captured), on the incremental engine's own weight tensors, with
    the 160M-class draft (random bf16 weights, seed 0: it speculates blind,
    so about one token verifies a step); width 3, depth 4, fused and
    pipelined as ``LLM.compile`` builds it. Every request's first ``PREFIX``
    tokens equal the incremental run's, every greedy iteration is a replay,
    one replayed horizon equals the uncaptured body bitwise, qmm_int8,
    decode_attention (the tree form in the verify) and flash_prefill launch,
    and the peak memory stays within ``MIXTRAL_SPEC_PEAK_GIB`` of the
    incremental run's."""
    import torch

    from flexflow_tpu_torch.config import config as ffconfig
    from flexflow_tpu_torch.models import params as params_lib
    from flexflow_tpu_torch.serving.spec_manager import SpecRequestManager
    from flexflow_tpu_torch.serving.speculative import SpecEngine, tree_size
    from flexflow_tpu_torch.specs import ModelSpec

    dev = engine.device
    spec = engine.spec
    dspec = ModelSpec(**DRAFT_160M)
    require(dspec.vocab_size == spec.vocab_size, "the draft and Mixtral need one vocabulary")
    dparams = params_lib.init_params(dspec, torch.Generator(device=dev).manual_seed(0),
                                     torch.bfloat16, dev)
    width, depth, seq = 3, 4, engine.max_seq_len
    horizon = max(1, min(ffconfig.spec_horizon, seq // (4 * (tree_size(width, depth) + 1))))
    spec_engine = SpecEngine(spec, engine.params, dspec, dparams, beam_width=width,
                             beam_depth=depth, max_requests_per_batch=engine.max_requests,
                             max_seq_len=seq, cache_dtype=torch.bfloat16, device=dev)
    require(_ptrs(spec_engine.llm_params) == _ptrs(engine.params),
            "the speculative engine copied Mixtral's weights")
    require(spec_engine.graphs is not None, "the dense-form Mixtral engine captures nothing")
    managers = [SpecRequestManager(spec_engine, fused=True, spec_horizon=horizon,
                                   pipelined=horizon > 1, pipeline_depth=ffconfig.pipeline_depth)
                for _ in range(2)]
    rm = managers[1]
    reqs, out = _served(rm, prompts, MIXTRAL_SPEC_NEW, spec.vocab_size, "mixtral speculative",
                        warm=managers[0])
    out.update(card=card, spec_horizon=horizon,
               mean_verified_tokens_per_step=rm.mean_verified_tokens_per_step,
               verify_rows=engine.max_requests * spec_engine.tree)
    _log_served("mixtral speculative", out, card)
    log(f"  mixtral speculative: mean verified tokens per step "
        f"{out['mean_verified_tokens_per_step']:.3f} (a random draft), {out['steps']} iterations "
        f"of a {out['verify_rows']}-row verify; decode {out['decode_tok_s']:.1f} against "
        f"incremental {incr['decode_tok_s']:.1f} tok/s, mean TTFT {out['mean_ttft_ms']:.1f} "
        f"against {incr['mean_ttft_ms']:.1f} ms, peak {out['peak_mem_gib']:.2f} against "
        f"{incr['peak_mem_gib']:.2f} GiB [{card}]")
    lens = spec_engine._h([len(p) for p in prompts])
    roots = spec_engine._h([(r.output_tokens[0] + 1) % spec.vocab_size for r in reqs])
    _replay_check(f"mixtral speculative horizon ({horizon} iterations, 8 slots)",
                  lambda replay: spec_engine.greedy_horizon_async(lens, roots, horizon,
                                                                  replay=replay),
                  [*spec_engine.llm_cache, *spec_engine.ssm_cache])
    out["tokens_equal_to_incremental"] = _prefix_equal("mixtral speculative", reqs, incr_reqs)
    for k in ("qmm_int8", "decode_attention", "flash_prefill"):
        require(out["launches"][k] > 0, f"{k} was never launched in the mixtral speculative run")
    require(out["peak_mem_gib"] <= incr["peak_mem_gib"] + MIXTRAL_SPEC_PEAK_GIB,
            f"mixtral speculative peak {out['peak_mem_gib']:.2f} GiB > the incremental run's "
            f"{incr['peak_mem_gib']:.2f} + {MIXTRAL_SPEC_PEAK_GIB}")
    del rm, managers, spec_engine, dparams
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# CPU offload
# ---------------------------------------------------------------------------

# Run (c)'s depth. bf16 Mixtral-8x7B holds 2.903 GB (2.703 GiB) of layer
# weights a layer, 86.5 GiB for all 32. The one-H100 machine has 101 GiB
# of memory, and a Python process holding a CUDA context sees 96.5 GiB
# available (the card phase's "host memory" line): 31 layers (83.8 GiB
# pinned) were the most that leave 12 GiB free, and ran until the full run
# neared its time limit; 16 (43.2 GiB) keep the streaming, the overlap and
# the peak-memory gate (two slots and the activations, ~8.6 GiB, under 25%
# of the stack) at about half the phase's time. Fixed here: the phase never
# shrinks itself at run time.
OFFLOAD_LAYERS = 16
OFFLOAD_A_NEW = 32  # run (a): new tokens a request (cut from the serve traffic's 64 for time)
OFFLOAD_NEW_TOKENS = 8  # runs (b) and (c): decode steps / tokens a request (cut from 16 for time)
OFFLOAD_PEAK_SHARE = 0.25  # run (c)'s peak device memory against the layer stack's bytes


def _meminfo_gib(path: str, key: str) -> float:
    """A ``kB`` field of ``/proc/meminfo`` or ``/proc/self/status``, in GiB."""
    with open(path) as f:
        for line in f:
            if line.startswith(key + ":"):
                return int(line.split()[1]) / 2**20
    raise PhaseError(f"no {key} in {path}")


def _mem_available_gib() -> float:
    return _meminfo_gib("/proc/meminfo", "MemAvailable")


def _rss_gib() -> float:
    """This process's resident memory (page-locked pages included)."""
    return _meminfo_gib("/proc/self/status", "VmRSS")


def _stepped_logits(engine, prompts, steps: int, layers=None):
    """The engine's batched prefill (flash, K/V written into its cache, as
    ``prefill_batch_to_slots_async`` does) of ``prompts`` into slots 0..n-1,
    then ``steps`` greedy decode steps through ``forward_cached``, straight
    on the engine's parameters (``layers`` in place of its layers, if
    given) and cache. Returns (logits [steps + 1, n, V]
    f32: the prefill's at each last prompt position, then each step's;
    wall seconds of the prefill and of each step, synchronised)."""
    import numpy as np
    import torch

    from flexflow_tpu_torch.models import decoder
    from flexflow_tpu_torch.models.decoder import to_device

    n = len(prompts)
    spec, dev = engine.spec, engine.device
    cache = decoder.KVCache(engine.cache.k[:, :n], engine.cache.v[:, :n])
    bucket = max(engine.prefill_bucket(len(p)) for p in prompts)
    toks = np.zeros((n, bucket), np.int32)
    lens = np.array([len(p) for p in prompts], np.int32)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    tk, ln = to_device(toks, dev), to_device(lens, dev)
    pos = torch.arange(bucket, dtype=torch.int32, device=dev)[None].expand(n, bucket)

    def sink(layer, k, v):
        decoder.commit_kv_windows(cache.k[layer:layer + 1], cache.v[layer:layer + 1],
                                  k.permute(0, 2, 1, 3)[None].to(cache.k.dtype),
                                  v.permute(0, 2, 1, 3)[None].to(cache.v.dtype),
                                  np.zeros(n, np.int64), list(range(n)))

    params = engine.params if layers is None else {**engine.params, "layers": layers}
    walls, out = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        lg, _ = decoder.forward(spec, params, tk, pos, lengths=ln, flash=True,
                                kv_sink=sink, logits_at=ln - 1)
        out.append(lg)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        cur, cl = lg.argmax(-1).to(torch.int32), ln.clone()
        for _ in range(steps):
            t0 = time.perf_counter()
            lg, _ = decoder.forward_cached(spec, params, cur[:, None], cache, cl)
            out.append(lg[:, 0])
            cur, cl = lg[:, 0].argmax(-1).to(torch.int32), cl + 1
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
    return torch.stack(out).float(), walls


def _h2d_gbps(reps: int = 3) -> float:
    """Host-to-device rate of one plain copy of 1 GiB from page-locked memory
    (the layer store's kind), mean of ``reps`` after a warm-up (CUDA events)."""
    import torch

    from flexflow_tpu_torch.models.layer_store import pinned_empty

    host = pinned_empty((1 << 30,), torch.uint8)
    dev = torch.empty((1 << 30,), dtype=torch.uint8, device="cuda")
    dev.copy_(host, non_blocking=True)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        dev.copy_(host, non_blocking=True)
    end.record()
    end.synchronize()
    return reps * (1 << 30) / (start.elapsed_time(end) / 1e3) / 1e9


def _served_stamped(rm, prompts, max_new: int, vocab_size: int, path: str):
    """``_served`` (no replays) noting the host time each of the engine's
    fetches returns: at horizon 1, not pipelined, each closes the prefill
    or a decode step. Returns (requests, stats, times). The engine's own
    ``fetch`` is back in place on return, and no reference to the engine
    outlives this call."""
    engine, stamps = rm.engine, []
    fetch = engine.fetch

    def timed_fetch(x):
        vals = fetch(x)
        stamps.append(time.monotonic())
        return vals

    engine.fetch = timed_fetch
    try:
        reqs, served = _served(rm, prompts, max_new, vocab_size, path, replayed=False)
    finally:
        del engine.fetch
    return reqs, served, stamps


def offload_llama_run(card: str) -> dict:
    """Run (a): LLaMA-2-7B INT8 resident against offload, the serve traffic."""
    import torch

    from flexflow_tpu_torch.models import params as params_lib
    from flexflow_tpu_torch.serving.engine import InferenceEngine
    from flexflow_tpu_torch.serving.request_manager import RequestManager
    from flexflow_tpu_torch.specs import ModelSpec

    dev = torch.device("cuda")
    spec = ModelSpec(**LLAMA2_7B)
    t0 = time.perf_counter()
    params = params_lib.init_quantized_params(
        spec, torch.Generator(device=dev).manual_seed(0), bits=8, group_size=128,
        dtype=torch.bfloat16, device=dev, host_layers=True)
    torch.cuda.synchronize()
    out = {"init_s": time.perf_counter() - t0}
    prompts = _prompts(spec.vocab_size)
    reqs = {}
    for offload in (False, True):
        name = "offload" if offload else "resident"
        engine = InferenceEngine(spec, params, max_requests_per_batch=8, max_seq_len=1024,
                                 max_tokens_per_batch=0, cache_dtype=torch.bfloat16, device=dev,
                                 offload=offload)
        rm = RequestManager(engine, decode_horizon=16, pipelined=True)
        try:
            reqs[name], out[name] = _served(rm, prompts, OFFLOAD_A_NEW, spec.vocab_size,
                                            f"offload (a) {name}", replayed=not offload)
        finally:
            rm.close()
        _log_served(f"(a) LLaMA-2-7B INT8 {name}", out[name], card)
        del engine, rm
        gc.collect()
        torch.cuda.empty_cache()
    for k in ("qmm_int8", "decode_attention", "flash_prefill"):
        require(out["offload"]["launches"][k] > 0, f"offload (a): {k} was never launched")
    same = [a.output_tokens == b.output_tokens for a, b in zip(reqs["resident"], reqs["offload"])]
    require(all(same), f"offload (a): tokens differ from the resident run's: {same}")
    log(f"  (a) all {len(same)} x {OFFLOAD_A_NEW} tokens equal to the resident run's; decode "
        f"{out['offload']['decode_tok_s']:.2f} tok/s offload against "
        f"{out['resident']['decode_tok_s']:.2f} resident [{card}]")
    return out


def offload_bitwise_run(card: str) -> dict:
    """Run (b): Mixtral-8x7B bf16 at full width, 4 layers, resident against
    offload: the prefill logits and ``OFFLOAD_NEW_TOKENS`` decode steps'
    logits bitwise."""
    import torch

    from flexflow_tpu_torch.models import params as params_lib
    from flexflow_tpu_torch.serving.engine import InferenceEngine

    dev = torch.device("cuda")
    spec = mixtral_spec(4)
    params = params_lib.init_params(spec, torch.Generator(device=dev).manual_seed(0),
                                    torch.bfloat16, dev, host_layers=True)
    prompts = _prompts(spec.vocab_size)
    logits, walls = {}, {}
    for offload in (False, True):
        engine = InferenceEngine(spec, params, max_requests_per_batch=8, max_seq_len=1024,
                                 cache_dtype=torch.bfloat16, device=dev, offload=offload)
        name = "offload" if offload else "resident"
        _stepped_logits(engine, prompts, 1)  # warm-up: the timed run below is not the first
        logits[name], walls[name] = _stepped_logits(engine, prompts, OFFLOAD_NEW_TOKENS)
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    del params
    g = logits["offload"]
    require(bool(torch.isfinite(g).all()) and g.shape == (OFFLOAD_NEW_TOKENS + 1, 8,
                                                         spec.vocab_size),
            f"offload (b): logits not finite or shaped {tuple(g.shape)}")
    equal = torch.equal(g, logits["resident"])
    require(equal, "offload (b): logits differ from the resident run's, max|diff| "
            f"{(g - logits['resident']).abs().max().item()}")
    out = dict(bitwise=equal, steps=OFFLOAD_NEW_TOKENS, walls_s=walls,
               layers=spec.num_layers)
    log(f"  (b) Mixtral-8x7B bf16, 4 layers: prefill and {OFFLOAD_NEW_TOKENS} decode steps' "
        f"logits bitwise equal to resident; prefill {walls['offload'][0]:.3f} s offload against "
        f"{walls['resident'][0]:.3f} s resident, a decode step {walls['offload'][1]:.3f} against "
        f"{walls['resident'][1]:.3f} s [{card}]")
    return out


def _staged_only(store):
    """A view of an engine's ``LayerStore`` (a subclass sharing its slots,
    stream and events) whose forwards read the two staged slots, layer i
    from slot i % 2, and copy nothing: the offload path's compute alone."""
    import torch

    from flexflow_tpu_torch.models.layer_store import LayerStore

    class StagedOnly(LayerStore):
        def __init__(self, store):
            self.__dict__.update(store.__dict__)

        def acquire(self, i):
            torch.cuda.current_stream(self.device).wait_event(self._copied[i % 2])
            return dict(self._views[i % 2])

        def release(self, i):
            pass

    return StagedOnly(store)


def offload_mixtral_run(card: str) -> dict:
    """Run (c): Mixtral-8x7B bf16 at full width, ``OFFLOAD_LAYERS`` deep,
    offload only: the served run (horizon 1, not pipelined, so each fetch
    closes a step), the copy-alone and compute-alone times, the host rate."""
    import numpy as np
    import torch

    from flexflow_tpu_torch.models import params as params_lib
    from flexflow_tpu_torch.models import layer_store as offload_lib
    from flexflow_tpu_torch.serving.engine import InferenceEngine
    from flexflow_tpu_torch.serving.request_manager import RequestManager

    dev = torch.device("cuda")
    spec = mixtral_spec(OFFLOAD_LAYERS)
    out = {"layers": spec.num_layers, "mem_available_gib_before": _mem_available_gib(),
           "rss_gib_before": _rss_gib()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pinned0, pin0, t0 = offload_lib.pinned_bytes, offload_lib.pin_seconds, time.perf_counter()
    params = params_lib.init_params(spec, torch.Generator(device=dev).manual_seed(0),
                                    torch.bfloat16, dev, host_layers=True)
    torch.cuda.synchronize()
    out.update(init_s=time.perf_counter() - t0, pin_s=offload_lib.pin_seconds - pin0,
               init_peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    engine = InferenceEngine(spec, params, max_requests_per_batch=8, max_seq_len=1024,
                             max_tokens_per_batch=0, cache_dtype=torch.bfloat16, device=dev,
                             offload=True)
    del params
    gc.collect()
    store = engine.params["layers"]
    out["stack_gib"] = store.layer_bytes * spec.num_layers / 2**30
    out["pinned_gib"] = (offload_lib.pinned_bytes - pinned0) / 2**30
    require(offload_lib.pinned_bytes - pinned0 == store.layer_bytes * spec.num_layers,
            f"offload (c): {out['pinned_gib']:.2f} GiB pinned for {out['stack_gib']:.2f} GiB "
            f"of layers: the stack is pinned more than once")
    out["layer_gb"] = store.layer_bytes / 1e9
    out["mem_available_gib_after"], out["rss_gib_after"] = _mem_available_gib(), _rss_gib()
    log(f"  (c) Mixtral-8x7B bf16, {spec.num_layers} layers: {out['stack_gib']:.2f} GiB of layers "
        f"pinned (one copy), init {out['init_s']:.1f} s (cudaHostRegister {out['pin_s']:.1f} s), init peak "
        f"{out['init_peak_gib']:.2f} GiB on the card; MemAvailable "
        f"{out['mem_available_gib_before']:.1f} -> {out['mem_available_gib_after']:.1f} GiB, "
        f"this process's RSS {out['rss_gib_before']:.1f} -> {out['rss_gib_after']:.1f} GiB "
        f"[{card}]")
    out["h2d_gbps"] = _h2d_gbps()
    prompts = _prompts(spec.vocab_size)
    rm = RequestManager(engine, decode_horizon=1, pipelined=False)
    try:
        reqs, served, stamps = _served_stamped(rm, prompts, OFFLOAD_NEW_TOKENS,
                                               spec.vocab_size, "offload (c)")
    finally:
        rm.close()
    out.update(served)
    # the served run's fetches: the admission's first tokens, then one a step
    t_reg = min(r.profile.start_time for r in reqs)
    marks = [s for s in stamps if s >= t_reg]
    out["prefill_wall_s"] = marks[0] - t_reg
    out["step_walls_s"] = list(np.diff(marks))
    require(len(out["step_walls_s"]) == OFFLOAD_NEW_TOKENS - 1,
            f"offload (c): {len(out['step_walls_s'])} decode steps timed")
    for k in ("decode_attention", "flash_prefill"):
        require(served["launches"][k] > 0, f"offload (c): {k} was never launched")
    # the stream alone: every layer copied once, no compute
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for layer in range(spec.num_layers):
        store._copy(layer % 2, layer)
    store._stream.synchronize()
    out["copy_alone_s"] = time.perf_counter() - t0
    store.restart(0)
    # the compute alone: a prefill and a decode step on the staged slots
    logits, walls = _stepped_logits(engine, prompts, 1, layers=_staged_only(store))
    out["compute_alone_prefill_s"], out["compute_alone_step_s"] = walls
    require(bool(torch.isfinite(logits).all()), "offload (c): compute-alone logits not finite")
    stream_s = store.layer_bytes * spec.num_layers / (out["h2d_gbps"] * 1e9)
    out["stream_s_at_h2d_rate"] = stream_s
    stack_bytes = store.layer_bytes * spec.num_layers
    require(served["peak_mem_gib"] * 2**30 < OFFLOAD_PEAK_SHARE * stack_bytes,
            f"offload (c): peak {served['peak_mem_gib']:.2f} GiB is not below "
            f"{OFFLOAD_PEAK_SHARE:.0%} of the layers' {stack_bytes / 2**30:.2f} GiB")
    overlap_limit = out["copy_alone_s"] + out["compute_alone_prefill_s"]
    require(out["mean_ttft_ms"] / 1e3 < overlap_limit,
            f"offload (c): prefill (mean TTFT) {out['mean_ttft_ms'] / 1e3:.3f} s is not below "
            f"copy-alone + compute-alone {overlap_limit:.3f} s: the copies do not overlap")
    steps = out["step_walls_s"]
    log(f"  (c) host->device {out['h2d_gbps']:.2f} GB/s (1 GiB from pinned memory); layers "
        f"{store.layer_bytes * spec.num_layers / 1e9:.2f} GB: {stream_s:.3f} s at that rate; "
        f"copy alone {out['copy_alone_s']:.3f} s; compute alone: prefill "
        f"{out['compute_alone_prefill_s']:.3f} s, a decode step "
        f"{out['compute_alone_step_s']:.3f} s [{card}]")
    log(f"  (c) served: TTFT mean {out['mean_ttft_ms']:.1f} ms (prefill wall "
        f"{out['prefill_wall_s']:.3f} s), decode steps {min(steps):.3f}-{max(steps):.3f} s "
        f"(mean {float(np.mean(steps)):.3f}), {out['decode_tok_s']:.2f} tok/s, peak "
        f"{out['peak_mem_gib']:.2f} GiB allocated ({out['peak_mem_gib'] * 2**30 / stack_bytes:.1%} "
        f"of the layers) [{card}]")
    log(f"  (c) decode step walls (s): {json.dumps([round(s, 4) for s in steps])}")
    del rm, engine, store
    gc.collect()
    torch.cuda.empty_cache()
    # the pinned layers leave the process with the engine (its RSS; the
    # machine's MemAvailable follows some seconds later)
    out["rss_gib_freed"] = _rss_gib()
    require(out["rss_gib_after"] - out["rss_gib_freed"] > 0.95 * out["stack_gib"],
            f"offload (c): RSS {out['rss_gib_freed']:.1f} GiB after the engine is freed, "
            f"{out['rss_gib_after']:.1f} with its {out['stack_gib']:.1f} GiB of layers pinned")
    log(f"  (c) engine freed: this process's RSS back to {out['rss_gib_freed']:.1f} GiB")
    return out


def offload_phase(card: str) -> dict:
    """CPU offload: run (a) LLaMA-2-7B INT8 resident against offload, (b)
    Mixtral-8x7B bf16 4 layers bitwise, (c) Mixtral-8x7B bf16 served from
    host memory at ``OFFLOAD_LAYERS`` layers."""
    out = {"llama": offload_llama_run(card), "bitwise": offload_bitwise_run(card),
           "mixtral": offload_mixtral_run(card)}
    out["card"] = card
    return out


def _lora_adapters(spec, n: int, device, seed: int, targets=LORA_TARGETS,
                   dtype: str = "bfloat16", lr: float = 1e-3):
    """``n`` LoRA adapters at rank 16, alpha 32 on ``targets`` (default the
    seven projections; SGD at ``lr`` when finetuned), in ``dtype``, A and B
    both drawn from one seeded generator (B non-zero, so every adapter
    acts). Returns (stacks, config)."""
    import torch

    from flexflow_tpu_torch.peft.lora import LoraConfig, init_lora_params

    cfg = LoraConfig(rank=16, alpha=32.0, target_modules=targets, learning_rate=lr)
    gen = torch.Generator(device=device).manual_seed(seed)
    lora = init_lora_params(spec, cfg, n, gen, getattr(torch, dtype), device)
    for ab in lora.values():
        ab["b"].copy_(torch.randn(ab["b"].shape, generator=gen, device=device) * LORA_B_STD)
    return lora, cfg


def crosscheck_lora(steps: int = LORA_CHECK_STEPS) -> dict:
    """2 layers at full 7B width, INT8, 4 adapters (seeds 1 and 2): a
    prefill of 4 requests routed [0, 3, -1, 1] and ``steps`` decode steps,
    teacher-forced by the GPU's LoRA tokens, through the kernels on the GPU
    with and without the adapters and through the plain versions on the CPU
    with them."""
    import numpy as np
    import torch

    from flexflow_tpu_torch.models import decoder
    from flexflow_tpu_torch.peft.lora import lora_scaling, route_lora
    from flexflow_tpu_torch.serving.engine import _params_to
    from flexflow_tpu_torch.specs import ModelSpec

    t0 = time.perf_counter()
    dev, host = torch.device("cuda"), torch.device("cpu")
    spec = ModelSpec(**{**LLAMA2_7B, "num_layers": 2})
    gpu = decoder.fuse_qkv_params(spec, _quant_params(spec, 1, dev))
    cpu = _params_to(gpu, host)
    lora, cfg = _lora_adapters(spec, 4, dev, 2)
    ids = [0, 3, -1, 1]
    scale = lora_scaling(cfg)
    sides = {"gpu": (dev, gpu, route_lora(lora)),
             "cpu": (host, cpu, route_lora(_params_to(lora, host))),
             "base": (dev, gpu, None)}
    rng = np.random.default_rng(4)
    lens = np.array([20, 13, 27, 9], np.int32)
    nb, t, s_max = len(lens), 32, 64
    toks = np.zeros((nb, t), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(3, spec.vocab_size, n)

    def routing(name):
        d, _, routed = sides[name]
        return {} if routed is None else dict(
            lora=routed, adapter_ids=torch.tensor(ids, device=d), lora_scale=scale)

    caches, logits = {}, {}
    for name, (d, params, _) in sides.items():
        cache = decoder.init_kv_cache(spec, nb, s_max, torch.bfloat16, d)
        ln = torch.as_tensor(lens, device=d)
        with torch.no_grad():
            lg, (k, v) = decoder.forward(
                spec, params, torch.as_tensor(toks, device=d),
                torch.arange(t, dtype=torch.int32, device=d)[None].expand(nb, t), lengths=ln,
                flash=True, return_kv=True, logits_at=ln - 1, **routing(name))
        decoder.commit_kv_windows(cache.k, cache.v, k.permute(0, 1, 3, 2, 4),
                                  v.permute(0, 1, 3, 2, 4), [0] * nb)
        caches[name], logits[name] = cache, [lg.float().cpu()]
    cur = logits["gpu"][0].argmax(-1)
    for i in range(steps):
        for name, (d, params, _) in sides.items():
            with torch.no_grad():
                lg, _ = decoder.forward_cached(
                    spec, params, cur[:, None].to(d), caches[name],
                    torch.as_tensor(lens + i, device=d), write_start=lens + i, **routing(name))
            logits[name].append(lg[:, 0].float().cpu())
        cur = logits["gpu"][-1].argmax(-1)
    g, c, b = (torch.stack(logits[n]) for n in ("gpu", "cpu", "base"))  # [steps + 1, B, V]
    require(g.shape == (steps + 1, nb, spec.vocab_size), f"logits shaped {tuple(g.shape)}")
    out = logits_rule(g, c, slice(None), "lora cross-check")
    acts = [(g[:, r] - b[:, r]).abs().max().item() for r in range(nb)]
    for r, a in enumerate(ids):
        if a >= 0:
            require(acts[r] > 10 * out["max_abs_err"],
                    f"lora cross-check: adapter {a}'s row moves the logits by {acts[r]:.4g}, not "
                    f"above 10 x the GPU-CPU error {out['max_abs_err']:.4g}")
        else:
            require(torch.equal(g[:, r], b[:, r]),
                    "lora cross-check: the -1 row's logits differ from the no-LoRA forward's")
    out.update(adapter_ids=ids, lora_minus_base=acts, seconds=time.perf_counter() - t0)
    log(f"  cross-check LoRA (2 layers, 4 adapters, rows {ids}, {steps} steps): logits max|err| "
        f"{out['max_abs_err']:.4g} (tol {out['tol']:.4g}); greedy tokens equal "
        f"{out['tokens_equal']}/{out['tokens']} ({out['decided']} beyond the error margin); "
        f"max|LoRA - base| per row {[f'{a:.4g}' for a in acts]} (the -1 row bitwise equal); "
        f"{out['seconds']:.1f} s")
    del gpu, cpu, caches, sides, lora
    torch.cuda.empty_cache()
    return out


def lora_trace(engine, prompts, adapters) -> dict:
    """One replayed 16-step decode horizon and one batched prefill of
    ``prompts`` on ``engine``, the 8 rows routed to ``adapters`` (None: no
    adapter), traced (``_trace``) with every kernel's device time kept
    under ``kernels_ms``; keyed by "decode_horizon_16" and "prefill_8x1024"."""
    import numpy as np

    from flexflow_tpu_torch.ops.sampling import SamplingConfig

    b = engine.max_requests
    greedy = SamplingConfig(np.zeros(b, np.float32), np.ones(b, np.float32),
                            np.zeros(b, np.int32))
    lens = np.array([len(p) for p in prompts], np.int32)
    toks = np.zeros(b, np.int32)
    tag = "lora" if adapters else "base"
    runs = _trace([
        (f"{tag} decode_horizon_16",
         lambda: engine.decode_horizon_async(lens, toks, 0, greedy, 16, adapter_ids=adapters), 16),
        (f"{tag} prefill_8x1024",
         lambda: engine.prefill_batch_to_slots_async(prompts, list(range(b)), 0, greedy,
                                                     adapter_ids=adapters), 1),
    ], keep_all=True)
    return {k.split(" ")[1]: v for k, v in runs.items()}


def lora_phase(card: str, with_profile: bool) -> dict:
    """LoRA serving at full LLaMA-2-7B width, INT8: the cross-check, the
    no-adapter run, the adapter run over the same weight tensors, the -1
    requests against the no-adapter run, one replayed horizon against the
    uncaptured body."""
    import numpy as np
    import torch

    from flexflow_tpu_torch.serving.engine import InferenceEngine
    from flexflow_tpu_torch.serving.request_manager import RequestManager
    from flexflow_tpu_torch.specs import ModelSpec

    out = {"crosscheck": crosscheck_lora()}
    dev = torch.device("cuda")
    spec = ModelSpec(**LLAMA2_7B)
    kw = dict(max_requests_per_batch=8, max_seq_len=1024, max_tokens_per_batch=0,
              cache_dtype=torch.bfloat16, device=dev)
    base = InferenceEngine(spec, _quant_params(spec, 0, dev), **kw)
    rm = RequestManager(base, decode_horizon=16, pipelined=True)
    prompts = _prompts(spec.vocab_size)
    try:
        base_reqs, out["base"] = _served(rm, prompts, 64, spec.vocab_size, "lora base")
        if with_profile:
            log("[profile] one decode horizon and one batched prefill without adapters")
            out["base"]["profile"] = lora_trace(base, prompts, None)
    finally:
        rm.close()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lora, cfg = _lora_adapters(spec, 4, dev, 0)
    torch.cuda.synchronize()
    out["adapters_build_s"] = time.perf_counter() - t0
    out["adapters_bytes"] = sum(x.numel() * x.element_size() for ab in lora.values()
                                for x in ab.values())
    # the base engine's fused weight tensors, shared: fusing them again is a no-op
    engine = InferenceEngine(spec, base.params, lora=lora, lora_config=cfg, **kw)
    out["routed_bytes"] = sum(x.numel() * x.element_size()
                              for part in (engine.lora.a, engine.lora.b) for x in part.values())
    del lora, base, rm
    torch.cuda.empty_cache()
    log(f"  adapters: 4 x rank 16 on {len(LORA_TARGETS)} projections x {spec.num_layers} layers, "
        f"{out['adapters_bytes'] / 2**20:.1f} MiB in bf16, built in "
        f"{out['adapters_build_s']:.3f} s; the engine's routing layout (float32) "
        f"{out['routed_bytes'] / 2**20:.1f} MiB [{card}]")
    rm = RequestManager(engine, decode_horizon=16, pipelined=True)
    try:
        reqs, served = _served(rm, prompts, 64, spec.vocab_size, "lora", adapters=LORA_IDS)
        out.update(served)
        for i, a in enumerate(LORA_IDS):
            if a < 0:
                require(reqs[i].output_tokens == base_reqs[i].output_tokens,
                        f"lora: request {i} (no adapter) differs from the no-adapter run's tokens")
        out["adapter_requests_changed"] = sum(
            reqs[i].output_tokens != base_reqs[i].output_tokens
            for i, a in enumerate(LORA_IDS) if a >= 0)
        require(out["adapter_requests_changed"] > 0,
                "lora: every adapter request gave the no-adapter run's tokens")
        lens = np.array([len(p) for p in prompts], np.int32)
        toks = np.array([(r.output_tokens[0] + 1) % spec.vocab_size for r in reqs], np.int32)
        _replay_check("lora decode horizon (16 steps, 8 slots)",
                      lambda replay: [engine.greedy_horizon_async(lens, toks, 16, replay=replay,
                                                                  adapter_ids=LORA_IDS)],
                      list(engine.cache))
        if with_profile:
            log("[profile] one decode horizon and one batched prefill with the adapters")
            out["profile"] = prof = lora_trace(engine, prompts, LORA_IDS)
            for what, run in prof.items():
                base_run = out["base"]["profile"][what]
                grown = {k: v - base_run["kernels_ms"].get(k, 0.0)
                         for k, v in run.pop("kernels_ms").items()}
                base_run.pop("kernels_ms")
                lora_ms = run["device_busy_ms"] - base_run["device_busy_ms"]
                run.update(lora_device_ms=lora_ms,
                           lora_device_share=lora_ms / run["device_busy_ms"],
                           grown_kernels_ms=dict(sorted(grown.items(), key=lambda kv: -kv[1])[:8]))
                log(f"  the adapters' device time in the {what}: {lora_ms:.2f} ms of "
                    f"{run['device_busy_ms']:.2f} ms busy ({100 * run['lora_device_share']:.1f}%) "
                    f"[{card}]; the kernels that grew most:")
                for k, v in run["grown_kernels_ms"].items():
                    log(f"    {v:9.3f} ms  {k[:100]}")
    finally:
        rm.close()
    for k in ("qmm_int8", "decode_attention", "flash_prefill"):
        require(out["launches"][k] > 0, f"{k} was never launched while serving with adapters")
    out["card"] = card
    _log_served("lora base (no adapters)", out["base"], card)
    _log_served("lora (4 adapters)", out, card)
    log(f"  lora: requests without an adapter equal the no-adapter run's tokens; "
        f"{out['adapter_requests_changed']} of 6 adapter requests changed tokens; LoRA / base "
        f"decode tok/s {out['decode_tok_s'] / out['base']['decode_tok_s']:.3f} [{card}]")
    del engine, rm
    torch.cuda.empty_cache()
    return out


def _quant_matmul_in_x_dtype(x, qa, *, layer=None, expert=None, out_dtype=None):
    """A second plain quant-matmul (stacked carriers, no experts): the plain
    dequantized weight multiplied in x's dtype by ``torch.matmul`` (cuBLAS,
    f32 accumulation) instead of in f32. Both are right; their difference
    is the noise floor of a bf16 forward."""
    import torch

    from flexflow_tpu_torch.ops.kernels import quant_matmul as qm

    del expert
    w = qm.dequant_weight(qa.q, qa.scale, qa.offset, qa.bits, qa.group_size, qa.d_rest, layer,
                          x.dtype)
    lead = x.shape[: x.dim() - qa.contract_dims]
    out = torch.matmul(x.reshape(-1, qa.d_contract), w).to(out_dtype or x.dtype)
    return out.reshape(*lead, *qa.shape[qa.batch_dims + qa.contract_dims:])


@contextlib.contextmanager
def _plain_quant_matmul(fn=None):
    """The decoder's quant-matmul calls go to a plain version (default
    ``quant_matmul_plain``; autograd through its torch ops): the yardstick
    of the kernels and of ``QuantMatmulFn``'s backward."""
    from flexflow_tpu_torch.models import decoder
    from flexflow_tpu_torch.ops.kernels import quant_matmul as qm

    kernel = decoder.quant_matmul
    decoder.quant_matmul = fn or qm.quant_matmul_plain
    try:
        yield
    finally:
        decoder.quant_matmul = kernel


def _finetune_data(vocab_size: int, seed: int = 6):
    """FT_SEQS seeded sequences of FT_LEN next-token pairs ([1, T] each)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(FT_SEQS):
        ids = rng.integers(3, vocab_size, FT_LEN + 1).astype(np.int32)
        out.append((ids[None, :-1], ids[None, 1:]))
    return out


def _lora_grads(session, engine, tokens, labels, plain=None):
    """One finetuning step's forward and backward with no update: (loss, the
    session slot's gradients {(module, "a" | "b"): [L, ...]}); through the
    kernels, or with ``plain`` (True, or a plain quant-matmul function)
    through a plain version."""
    with (_plain_quant_matmul(None if plain is True else plain) if plain
          else contextlib.nullcontext()):
        loss = session.loss(engine, tokens, labels)
        loss.backward()
    grads = {}
    for mod, ab in session.params.items():
        for k, p in ab.items():
            grads[(mod, k)] = p.grad.detach().float().clone()
            p.grad = None
    return float(loss.detach()), grads


def _grad_rule(got, want, what: str, min_cos: float, max_rel: float) -> dict:
    """Per tensor (module, a or b, layer): cosine and relative L2 distance of
    ``got`` to ``want``; every tensor non-zero, within both limits."""
    rows = []
    for key, w in want.items():
        g = got[key].to(w.device)
        for layer in range(w.shape[0]):
            gl, wl = g[layer].flatten().double(), w[layer].flatten().double()
            wn = wl.norm().item()
            require(wn > 0 and gl.norm().item() > 0,
                    f"{what}: {key} layer {layer} has a zero gradient")
            cos = (gl @ wl).item() / (gl.norm().item() * wn)
            rows.append((f"{key[0]}.{key[1]}", layer, cos, (gl - wl).norm().item() / wn))
    bad = [r for r in rows if r[2] < min_cos or r[3] > max_rel]
    require(not bad, f"{what}: tensors off the limits (cosine >= {min_cos}, rel L2 <= "
                     f"{max_rel}): {bad[:6]}")
    out = dict(tensors=len(rows), min_cosine=min(r[2] for r in rows),
               max_rel_l2=max(r[3] for r in rows),
               layer0={name: (cos, rel) for name, layer, cos, rel in rows if layer == 0})
    log(f"  {what}: {len(rows)} tensors, min cosine {out['min_cosine']:.6f}, max rel L2 "
        f"{out['max_rel_l2']:.3g}; layer 0 (cosine, rel L2) "
        f"{ {k: (round(c, 6), float(f'{r:.3g}')) for k, (c, r) in out['layer0'].items()} }")
    return out


def crosscheck_finetune() -> dict:
    """2 layers at full 7B width, INT8 with f32 activations, two adapter
    slots (A and B drawn): one finetuning step's loss and slot-1 gradients
    through the kernels on the GPU against the plain versions on the CPU,
    each tensor within 1e-3 (relative L2)."""
    import torch

    from flexflow_tpu_torch.models import decoder
    from flexflow_tpu_torch.models import params as params_lib
    from flexflow_tpu_torch.peft.finetune import FinetuneSession
    from flexflow_tpu_torch.quant import quantize_params
    from flexflow_tpu_torch.serving.engine import InferenceEngine, _params_to
    from flexflow_tpu_torch.specs import ModelSpec

    dev, host = torch.device("cuda"), torch.device("cpu")
    spec = ModelSpec(**{**LLAMA2_7B, "num_layers": 2})
    gen = torch.Generator(device=dev).manual_seed(1)
    params = quantize_params(spec, params_lib.init_params(spec, gen, torch.float32, dev),
                             bits=8, group_size=128, compute_dtype=torch.float32)
    params = decoder.fuse_qkv_params(spec, params)
    lora, cfg = _lora_adapters(spec, 2, dev, 3, FT_TARGETS, "float32", FT_LR)
    tokens, labels = (a[:, :64] for a in _finetune_data(spec.vocab_size)[0])
    out = {}
    for name, d in (("gpu", dev), ("cpu", host)):
        engine = InferenceEngine(spec, _params_to(params, d), max_requests_per_batch=1,
                                 max_seq_len=64, cache_dtype=torch.float32, device=d,
                                 lora=_params_to(lora, d), lora_config=cfg)
        out[name] = _lora_grads(FinetuneSession(spec, cfg, 1, [(tokens, labels)]), engine,
                                tokens, labels)
        del engine
    (lg, gg), (lc, gc) = out["gpu"], out["cpu"]
    require(abs(lg - lc) <= 1e-3 * abs(lc), f"finetune cross-check loss {lg} vs CPU {lc}")
    res = _grad_rule(gg, gc, "finetune cross-check (2 layers, f32, GPU kernels vs CPU plain)",
                     0.999, 1e-3)
    res.update(loss_gpu=lg, loss_cpu=lc)
    del params, lora, out
    torch.cuda.empty_cache()
    return res


def _f32_tree(params):
    """The served tree with f32 activations: quantized carriers shared (their
    compute dtype f32), other leaves cast."""
    import torch

    from flexflow_tpu_torch.quant.weight_only import QuantizedArray

    if isinstance(params, dict):
        return {k: _f32_tree(v) for k, v in params.items()}
    if isinstance(params, QuantizedArray):
        return dataclasses.replace(params, dtype=torch.float32)
    return params.float() if isinstance(params, torch.Tensor) else params


def _dx_rows(engine, card: str) -> dict:
    """QuantMatmulFn's backward at a finetune step's FT_LEN rows on each of
    the engine's quantized carriers (layer 0; the lm_head): the plain
    dequant of one carrier and the bf16 torch.matmul, device time beside its
    bound (the carrier, dy and dx moved once; 2 m D F operations)."""
    import torch

    from flexflow_tpu_torch.ops.kernels import quant_matmul as qm

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(21)
    layers = engine.params["layers"]
    carriers = [(k, layers[k], 0, engine.spec.num_layers) for k in ("wqkv", "wo", "wgu", "wd")]
    carriers.append(("lm_head", engine.params["lm_head"], None, 1))
    out, total = {}, 0.0
    for name, qa, layer, per_step in carriers:
        d, f = qa.d_contract, qa.d_rest
        dtype = torch.float32 if name == "lm_head" else torch.bfloat16
        dy = torch.randn((FT_LEN, f), generator=gen, device=dev).to(dtype)

        def dx():
            w = qm.dequant_weight(qa.q, qa.scale, qa.offset, qa.bits, qa.group_size, f, layer,
                                  torch.bfloat16)
            return torch.matmul(dy.to(torch.bfloat16), w.t())

        ms = time_ms(dx, 10)
        nbytes = dy.numel() * dy.element_size() + _weight_bytes(8, d, qa.q.shape[-1],
                                                               qa.group_size) + FT_LEN * d * 2
        b_ms, b_by = bound(nbytes, 2.0 * FT_LEN * d * f, PEAK_BF16_FLOPS)
        out[name] = dict(ms=ms, bound_ms=b_ms, bound_by=b_by, per_step=per_step)
        total += ms * per_step
        log(f"  backward dx {name} {d}x{f} m={FT_LEN} (dequant + bf16 torch.matmul, not a TPU "
            f"kernel): {ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), {per_step} a step [{card}]")
    out["per_step_ms"] = total
    return out


def finetune_phase(card: str) -> dict:
    """Co-scheduled LoRA finetuning at full LLaMA-2-7B depth and width, INT8:
    (a) one step's slot gradients through the kernels and QuantMatmulFn
    against the plain quant-matmul on the card, with f32 activations
    (cosine >= 0.999, relative L2 <= 3e-2 per tensor) and with bf16 ones
    (within 1.5x the floor between two plain versions), and a 2-layer f32
    check against the CPU; (b) the 8 prompts routed FT_IDS served with a session
    training slot 1: tokens equal the run without it, every greedy step a
    replay, each sequence's loss falls over the epochs; (c) slot 1 served after training: tokens differ
    from before it, and a replayed horizon equals the uncaptured body on the
    updated adapter; (d) slot 1 exported and loaded into a fresh engine's
    slot bitwise. Prints the step's forward, backward (the dequant + matmul
    part apart) and update times, decode tok/s with and without the session
    and peak memory."""
    import numpy as np
    import torch

    from flexflow_tpu_torch.ops.kernels import quant_matmul as qm
    from flexflow_tpu_torch.peft.finetune import FinetuneSession
    from flexflow_tpu_torch.peft.lora import (export_hf_adapter, init_lora_params,
                                             load_hf_adapter_into_slot, unroute_lora)
    from flexflow_tpu_torch.serving.engine import InferenceEngine
    from flexflow_tpu_torch.serving.request_manager import RequestManager
    from flexflow_tpu_torch.specs import ModelSpec

    out = {"crosscheck": crosscheck_finetune()}
    dev = torch.device("cuda")
    spec = ModelSpec(**LLAMA2_7B)
    lora, cfg = _lora_adapters(spec, 2, dev, 0, FT_TARGETS, lr=FT_LR)
    engine = InferenceEngine(spec, _quant_params(spec, 0, dev), max_requests_per_batch=8,
                             max_seq_len=1024, max_tokens_per_batch=0,
                             cache_dtype=torch.bfloat16, device=dev, lora=lora, lora_config=cfg)
    del lora
    data = _finetune_data(spec.vocab_size)
    r, n_layers = cfg.rank, spec.num_layers

    # (a) one step's gradients through the kernels against the plain path,
    # layer 0 included: with f32 activations over the same carriers (the
    # f32 kernel regime) at fixed limits; with the served bf16 activations
    # against the floor that a second plain version sets (two right bf16
    # forwards part by their roundings, amplified over 32 layers)
    f32 = InferenceEngine(spec, _f32_tree(engine.params), max_requests_per_batch=1,
                          max_seq_len=16, cache_dtype=torch.float32, device=dev,
                          lora=unroute_lora(engine.lora), lora_config=cfg)
    probe = FinetuneSession(spec, cfg, 1, data)
    loss_k, grads_k = _lora_grads(probe, f32, *data[0])
    loss_p, grads_p = _lora_grads(FinetuneSession(spec, cfg, 1, data), f32, *data[0], plain=True)
    require(abs(loss_k - loss_p) <= 1e-5 * abs(loss_p),
            f"finetune: f32 loss through the kernels {loss_k} vs the plain path {loss_p}")
    out["grads_f32"] = _grad_rule(grads_k, grads_p, "finetune gradients (32 layers, f32 "
                                  "activations, kernels + QuantMatmulFn vs plain quant-matmul)",
                                  0.999, 3e-2)
    del f32, probe, grads_k, grads_p
    torch.cuda.empty_cache()
    probe = FinetuneSession(spec, cfg, 1, data)
    launches, calls = qm.LAUNCHES, qm.BACKWARD_CALLS
    loss_k, grads_k = _lora_grads(probe, engine, *data[0])
    out["grad_launches"] = dict(qmm_int8=qm.LAUNCHES - launches,
                                backward=qm.BACKWARD_CALLS - calls)
    # every base projection and the lm_head launch K1/K3 forward; each passes
    # its gradient back through QuantMatmulFn but layer 0's wqkv, whose input
    # (the embedding) trains nothing
    want = dict(qmm_int8=4 * n_layers + 1, backward=4 * n_layers)
    require(out["grad_launches"] == want,
            f"finetune: a step launched {out['grad_launches']}, expected {want}")
    loss_p, grads_p = _lora_grads(probe, engine, *data[0], plain=True)
    loss_b, grads_b = _lora_grads(probe, engine, *data[0], plain=_quant_matmul_in_x_dtype)
    torch.cuda.empty_cache()
    floor = _grad_rule(grads_b, grads_p, "bf16 floor: plain in bf16 vs plain in f32 products "
                       "(32 layers, both right)", 0.99, 1.0)
    k_cos, k_rel = 1 - 1.5 * (1 - floor["min_cosine"]), 1.5 * floor["max_rel_l2"]
    out["grads"] = _grad_rule(grads_k, grads_p, "finetune gradients (32 layers, bf16, kernels + "
                              "QuantMatmulFn vs plain quant-matmul; limits 1.5x the floor)",
                              k_cos, k_rel)
    require(abs(loss_k - loss_p) <= 2 * abs(loss_b - loss_p) + 1e-6 * abs(loss_p),
            f"finetune: bf16 loss through the kernels {loss_k} vs the plain path {loss_p} "
            f"(the second plain version {loss_b})")
    out["grads"].update(loss_kernels=loss_k, loss_plain=loss_p, loss_plain_bf16=loss_b,
                        floor=floor)
    del grads_k, grads_p, grads_b, probe

    # (b) served with and without a co-scheduled session
    rm = RequestManager(engine, decode_horizon=16, pipelined=True)
    prompts = _prompts(spec.vocab_size)
    routed_ptrs = [t.data_ptr() for part in (engine.lora.a, engine.lora.b) for t in part.values()]
    slot0 = [t.clone() for t in (*(a[..., :r] for a in engine.lora.a.values()),
                                 *(b[:, :r] for b in engine.lora.b.values()))]
    try:
        base_reqs, out["base"] = _served(rm, prompts, 64, spec.vocab_size, "finetune base",
                                         adapters=FT_IDS)
        pre_reqs, _ = _served(rm, prompts, 64, spec.vocab_size, "slot 1 before training",
                              adapters=[1] * 8)
        session = FinetuneSession(spec, cfg, 1, data, epochs=FT_STEPS // FT_SEQS)
        reqs, served = _served(rm, prompts, 64, spec.vocab_size, "finetune co-scheduled",
                               adapters=FT_IDS, session=session)
        out.update(served)
        require([q.output_tokens for q in reqs] == [q.output_tokens for q in base_reqs],
                "finetune: the co-scheduled run's tokens differ from the run without a session")
        losses = session.losses
        out["losses"] = losses
        # step i trains sequence i % FT_SEQS: each sequence's loss must fall
        # from the first epoch to the last (the first and the last step see
        # different sequences)
        require(len(losses) == FT_STEPS and all(
            losses[-FT_SEQS + i] < losses[i] for i in range(FT_SEQS)),
            f"finetune: {len(losses)} steps, losses {losses}")
        require(all(torch.equal(a, b) for a, b in zip(
            slot0, (*(a[..., :r] for a in engine.lora.a.values()),
                    *(b[:, :r] for b in engine.lora.b.values())))),
                "finetune: slot 0 changed")
        require(routed_ptrs == [t.data_ptr() for part in (engine.lora.a, engine.lora.b)
                                for t in part.values()],
                "finetune: the routed adapters were reallocated, not updated in place")
        log(f"  finetune losses over {FT_STEPS} steps: {[round(v, 4) for v in losses]}; by "
            f"sequence, epoch 1 -> {FT_STEPS // FT_SEQS}: "
            f"{[(round(losses[i], 4), round(losses[-FT_SEQS + i], 4)) for i in range(FT_SEQS)]}")

        # the step's parts, timed on the device (4 more steps of slot 1)
        timer = FinetuneSession(spec, cfg, 1, data)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        parts = []
        for i in range(1 + FT_SEQS):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            ev[0].record()
            loss = timer.loss(engine, *data[i % FT_SEQS])
            ev[1].record()
            loss.backward()
            ev[2].record()
            timer.update()
            ev[3].record()
            parts.append(ev)
        torch.cuda.synchronize()
        step = {k: float(np.mean([e[j].elapsed_time(e[j + 1]) for e in parts[1:]]))
                for j, k in enumerate(("forward_ms", "backward_ms", "update_ms"))}
        step["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
        step["dx"] = _dx_rows(engine, card)
        out["step"] = step
        log(f"  finetune step (1 x {FT_LEN} tokens, device time, mean of {FT_SEQS}): forward "
            f"{step['forward_ms']:.2f} ms, backward {step['backward_ms']:.2f} ms (of it the "
            f"dequant + matmul dx, timed alone: {step['dx']['per_step_ms']:.2f} ms), update "
            f"{step['update_ms']:.3f} ms; peak memory {step['peak_mem_gib']:.2f} GiB [{card}]")

        # (c) the trained slot, served and replayed
        post_reqs, out["after"] = _served(rm, prompts, 64, spec.vocab_size,
                                          "slot 1 after training", adapters=[1] * 8)
        out["slot1_requests_changed"] = sum(a.output_tokens != b.output_tokens
                                            for a, b in zip(post_reqs, pre_reqs))
        require(out["slot1_requests_changed"] > 0,
                "finetune: slot 1 serves the same tokens after training as before")
        lens = np.array([len(p) for p in prompts], np.int32)
        toks = np.array([(q.output_tokens[0] + 1) % spec.vocab_size for q in post_reqs], np.int32)
        _replay_check("trained slot-1 decode horizon (16 steps, 8 slots)",
                      lambda replay: [engine.greedy_horizon_async(lens, toks, 16, replay=replay,
                                                                  adapter_ids=[1] * 8)],
                      list(engine.cache))
    finally:
        rm.close()

    # (d) export slot 1, load it into a fresh engine's slot 0
    with tempfile.TemporaryDirectory(prefix=".finetune_export_",
                                     dir=os.path.dirname(os.path.abspath(__file__))) as d:
        export_hf_adapter(d, spec, unroute_lora(engine.lora), 1, cfg)
        gen = torch.Generator(device=dev).manual_seed(9)
        fresh = init_lora_params(spec, cfg, 2, gen, torch.float32, dev)
        load_hf_adapter_into_slot(d, spec, fresh, 0, cfg)
    other = InferenceEngine(spec, engine.params, max_requests_per_batch=1, max_seq_len=64,
                            cache_dtype=torch.bfloat16, device=dev, lora=fresh, lora_config=cfg)
    require(all(torch.equal(other.lora.a[m][..., :r], engine.lora.a[m][..., r:2 * r])
                and torch.equal(other.lora.b[m][:, :r], engine.lora.b[m][:, r:2 * r])
                for m in engine.lora.a),
            "finetune: the exported slot, loaded into a fresh engine, differs from the trained one")
    log("  finetune: slot 1 exported (HF PEFT) and loaded into a fresh engine's slot 0 bitwise")
    for k in ("qmm_int8", "decode_attention", "flash_prefill"):
        require(out["launches"][k] > 0, f"{k} was never launched in the co-scheduled run")
    out["card"] = card
    _log_served("finetune base (no session)", out["base"], card)
    _log_served("finetune co-scheduled (session on slot 1)", out, card)
    log(f"  finetune: co-scheduled tokens equal the run without a session; decode tok/s with "
        f"/ without the session {out['decode_tok_s']:.1f} / {out['base']['decode_tok_s']:.1f}; "
        f"{out['slot1_requests_changed']} of 8 slot-1 requests changed tokens after training "
        f"[{card}]")
    del engine, other, rm, fresh
    torch.cuda.empty_cache()
    return out


def _param_leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _param_leaves(v, f"{prefix}{k}/")
        elif v is not None:
            yield f"{prefix}{k}", v


def train_phase(card: str) -> dict:
    """The Trainer at LLaMA-2-7B width, TRAIN_LAYERS layers (f32 params,
    gradients and Adam's m and v take 16 B a parameter: 32 layers would not
    fit the card), seed 0: a B=1, T=64 first step on the card against the
    same step on the CPU (loss rtol 1e-4, gradients 1e-4 of each leaf's
    magnitude, updated parameters atol 1e-5 where the gradient's sign is
    decided), TRAIN_STEPS Adam steps on one fixed TRAIN_BATCH x TRAIN_LEN
    batch (the loss must fall), and a save_checkpoint / load_checkpoint
    resume that gives the same next loss."""
    import numpy as np
    import torch

    from flexflow_tpu_torch.models import decoder
    from flexflow_tpu_torch.models import params as params_lib
    from flexflow_tpu_torch.specs import ModelSpec
    from flexflow_tpu_torch.training import AdamOptimizer, Trainer
    from flexflow_tpu_torch.training.losses import sparse_categorical_crossentropy
    from flexflow_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint

    require(not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32,
            "train: TF32 must stay off for the f32 comparison")
    dev, host = torch.device("cuda"), torch.device("cpu")
    spec = ModelSpec(**{**LLAMA2_7B, "num_layers": TRAIN_LAYERS})
    t0 = time.perf_counter()
    params = params_lib.init_params(spec, 0, torch.float32, host)
    n_params = sum(p.numel() for _, p in _param_leaves(params))
    out = dict(params=n_params, init_s=time.perf_counter() - t0)
    rng = np.random.default_rng(7)
    ids = rng.integers(3, spec.vocab_size, (1, 65)).astype(np.int32)
    x, y = ids[:, :-1], ids[:, 1:]

    def grads_of(tr):
        """The step's gradients (the Trainer's forward and loss, no update)."""
        t = torch.as_tensor(x, device=tr.device)
        pos = torch.arange(t.shape[1], dtype=torch.int32, device=tr.device)[None]
        logits, _ = decoder.forward(spec, tr.params, t, pos)
        sparse_categorical_crossentropy(logits, torch.as_tensor(y, device=tr.device)).backward()
        g = {}
        for name, p in _param_leaves(tr.params):
            g[name] = p.grad.detach().to(host, copy=True)
            p.grad = None
        return g

    ref = {}
    for name, d in (("cpu", host), ("gpu", dev)):
        t1 = time.perf_counter()
        tr = Trainer(spec, params, AdamOptimizer(lr=TRAIN_LR), device=d)
        grads = grads_of(tr)
        loss = tr.train_step(x, y)
        new = {k: p.detach().to(host, copy=True) for k, p in _param_leaves(tr.params)}
        ref[name] = (loss, grads, new)
        log(f"  first step (1 x 64 tokens) on the {name}: loss {loss:.6f} in "
            f"{time.perf_counter() - t1:.1f} s with the gradient probe")
        del tr
    (lc, gc, pc), (lg, gg, pg) = ref["cpu"], ref["gpu"]
    require(abs(lg - lc) <= 1e-4 * abs(lc), f"train: first loss {lg} on the card vs {lc}")
    worst_g, undecided, off = 0.0, 0, 0
    for k in gc:
        err = (gg[k] - gc[k]).abs()
        scale = gc[k].abs().max().item()
        worst_g = max(worst_g, err.max().item() / max(scale, 1e-30))
        # Adam's first update is lr * g / (|g| + eps): about lr * sign(g). A
        # gradient within the two sides' difference may take either sign.
        decided = gc[k].abs() > 2 * err.max()
        dp = (pg[k] - pc[k]).abs()
        off += int((dp[decided] > 1e-5).sum())
        undecided += int((~decided & (dp > 1e-5)).sum())
        require(bool((dp[~decided] <= 2 * TRAIN_LR + 1e-5).all()),
                f"train: {k} moved apart by more than 2 lr")
    require(worst_g <= 1e-4, f"train: gradients differ by {worst_g} of their magnitude")
    require(off == 0, f"train: {off} updated parameters with a decided gradient sign differ by "
                      "more than 1e-5")
    out.update(first_loss_gpu=lg, first_loss_cpu=lc, grad_rel_err=worst_g,
               sign_ties_apart=undecided)
    log(f"  first step: loss {lg:.6f} vs CPU {lc:.6f}; gradients within {worst_g:.3g} of each "
        f"leaf's magnitude; updated parameters within 1e-5 except {undecided} of {n_params} "
        f"whose gradient sign the two sides' difference leaves open (Adam moves them by "
        f"+-lr)")
    del ref, gc, gg, pc, pg

    batch = rng.integers(3, spec.vocab_size, (TRAIN_BATCH, TRAIN_LEN + 1)).astype(np.int32)
    bx, by = batch[:, :-1], batch[:, 1:]
    tr = Trainer(spec, params, AdamOptimizer(lr=TRAIN_LR), device=dev)
    del params
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, step_s = [], []
    for _ in range(TRAIN_STEPS):
        t1 = time.perf_counter()
        losses.append(tr.train_step(bx, by))  # returns a float: the step has finished
        step_s.append(time.perf_counter() - t1)
    peak = torch.cuda.max_memory_allocated() / 2**30
    require(losses[-1] < losses[0], f"train: the loss did not fall: {losses}")
    step_ms = 1e3 * float(np.mean(step_s[1:]))
    out.update(losses=losses, step_ms=step_ms, first_step_ms=1e3 * step_s[0],
               tokens_per_s=TRAIN_BATCH * TRAIN_LEN / (step_ms / 1e3), peak_mem_gib=peak)
    _SERVED["train_step_ms"] = step_ms  # for the meshtrain phase's (a)
    log(f"  {TRAIN_STEPS} Adam steps on {TRAIN_BATCH} x {TRAIN_LEN} tokens: losses "
        f"{[round(v, 4) for v in losses]}; step {step_ms:.1f} ms (first {1e3 * step_s[0]:.1f}), "
        f"{out['tokens_per_s']:.0f} tokens/s, peak memory {peak:.2f} GiB, {n_params} parameters "
        f"[{card}]")

    t1 = time.perf_counter()
    buf = io.BytesIO()
    save_checkpoint(buf, {"params": tr.params, "opt_state": tr.opt_state})
    buf.seek(0)
    state = load_checkpoint(buf, device=dev)
    del buf
    resumed = Trainer(spec, state["params"], AdamOptimizer(lr=TRAIN_LR), device=dev)
    resumed.opt_state = state["opt_state"]
    del state
    out["checkpoint_s"] = time.perf_counter() - t1
    want, got = tr.train_step(bx, by), resumed.train_step(bx, by)
    require(abs(got - want) <= 1e-6 * abs(want),
            f"train: the resumed step's loss {got} vs {want}")
    out.update(next_loss=want, resumed_loss=got)
    log(f"  checkpoint save + load + resume {out['checkpoint_s']:.1f} s: next loss {got:.6f} "
        f"equals the uninterrupted run's {want:.6f}")
    del tr, resumed
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# the graph layer (FFModel, Keras, the frontends)
# ---------------------------------------------------------------------------


def graph_flops(ff) -> float:
    """A forward's FLOPs at the graph's shapes: 2 x the multiply-adds of its
    products (dense, conv2d, batch_matmul); the elementwise ops are left out."""
    total = 0
    for n in ff._nodes:
        out = math.prod(n.out_shapes[0])
        if n.op in ("dense", "batch_matmul"):
            total += 2 * out * n.inputs[0].shape[-1]
        elif n.op == "conv2d":
            kh, kw = n.attrs["kernel"]
            total += 2 * out * (n.inputs[0].shape[1] // n.attrs["groups"]) * kh * kw
    return float(total)


def _numpy_tree(tree) -> dict:
    return {k: {leaf: v.detach().cpu().numpy() for leaf, v in d.items()} for k, d in tree.items()}


def _within(got, want, rel: float, what: str) -> float:
    """max |got - want| over max |want|, required <= ``rel``."""
    import numpy as np

    err = float(np.abs(np.asarray(got, np.float64) - want).max())
    scale = float(np.abs(want).max())
    require(err <= rel * scale, f"{what}: max |err| {err:.3g} over a magnitude {scale:.3g}")
    return err / scale


def _graph_train(ff, x, y, steps: int, items: int, unit: str, what: str, card: str,
                 falls: bool = True) -> dict:
    """``steps`` training steps on one fixed batch (each loss read back, so
    each step's wall time closes on the device), then the step's device time
    (CUDA events over steps queued behind a sleep) and its model FLOPs (3x
    the forward's) as a share of the card's f32 peak. ``x``: one input or a
    list; the last loss must be below the first unless ``falls`` is False
    (a graph that learns too slowly to show it in ``steps``)."""
    import numpy as np
    import torch

    inputs, labels = ff._to_inputs(x if isinstance(x, list) else [x]), ff._to_labels(y)
    gen = torch.Generator(device=ff.device).manual_seed(1)  # dropout masks
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, wall = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        loss, _ = ff._step(inputs, labels, gen)
        losses.append(loss.item())
        wall.append(time.perf_counter() - t0)
    dev_ms = time_ms(lambda: ff._step(inputs, labels, gen), reps=3, warmup=1)
    peak = torch.cuda.max_memory_allocated() / 2**30
    require(all(np.isfinite(losses)), f"{what}: a loss is not finite: {losses}")
    require(not falls or losses[-1] < losses[0], f"{what}: the loss did not fall: {losses}")
    wall_ms = 1e3 * float(np.mean(wall[1:]))
    flops = 3 * graph_flops(ff)
    out = dict(losses=losses, wall_ms=wall_ms, first_wall_ms=1e3 * wall[0], device_ms=dev_ms,
               per_s=items / (wall_ms / 1e3), per_s_device=items / (dev_ms / 1e3),
               model_tflop=flops / 1e12, f32_peak_share=flops / (dev_ms / 1e3) / PEAK_F32_FLOPS,
               peak_mem_gib=peak)
    log(f"  {what}: {steps} steps, losses {[round(v, 5) for v in losses]}; step wall "
        f"{wall_ms:.2f} ms (first {out['first_wall_ms']:.1f}), device {dev_ms:.2f} ms (host "
        f"dispatch shows as the gap); {out['per_s']:.1f} {unit}/s ({out['per_s_device']:.1f} at "
        f"device time); {flops / 1e12:.3f} TFLOP a step (3x the forward's products) = "
        f"{out['f32_peak_share']:.1%} of the f32 peak ({PEAK_F32_FLOPS / 1e12:.0f} TFLOP/s); "
        f"peak memory {peak:.2f} GiB [{card}]")
    return out


def _residual_cnn():
    """A resnet-style module (tests/test_frontend_widening.py's MiniResNet):
    stem, two basic blocks (the second strided, with a projection), adaptive
    average pool, flatten, linear; batch norms in eval mode."""
    import torch.nn as tnn

    class Block(tnn.Module):
        def __init__(self, cin, cout, stride=1):
            super().__init__()
            self.conv1 = tnn.Conv2d(cin, cout, 3, stride, 1, bias=False)
            self.bn1 = tnn.BatchNorm2d(cout)
            self.relu = tnn.ReLU()
            self.conv2 = tnn.Conv2d(cout, cout, 3, 1, 1, bias=False)
            self.bn2 = tnn.BatchNorm2d(cout)
            self.down = (tnn.Sequential(tnn.Conv2d(cin, cout, 1, stride, bias=False),
                                        tnn.BatchNorm2d(cout))
                         if stride != 1 or cin != cout else None)

        def forward(self, x):
            idn = x if self.down is None else self.down(x)
            out = self.relu(self.bn1(self.conv1(x)))
            out = self.bn2(self.conv2(out))
            return self.relu(out + idn)

    class ResCNN(tnn.Module):
        def __init__(self):
            super().__init__()
            self.conv1 = tnn.Conv2d(3, 16, 3, 1, 1, bias=False)
            self.bn1 = tnn.BatchNorm2d(16)
            self.relu = tnn.ReLU()
            self.maxpool = tnn.MaxPool2d(2, 2)
            self.layer1 = Block(16, 16)
            self.layer2 = Block(16, 32, stride=2)
            self.avgpool = tnn.AdaptiveAvgPool2d((1, 1))
            self.flatten = tnn.Flatten()
            self.fc = tnn.Linear(32, 10)

        def forward(self, x):
            x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
            x = self.layer2(self.layer1(x))
            return self.fc(self.flatten(self.avgpool(x)))

    return ResCNN()


def graph_phase(card: str) -> dict:
    """The graph layer on the card: (a) AlexNet, (b) the BERT-large proxy,
    (c) a Keras CNN, (d) the torch.fx / serialized-IR / ONNX frontends. Each
    cross-check runs the same parameters on the CPU (or in numpy)."""
    import numpy as np
    import torch

    import flexflow_tpu_torch.keras as keras
    from flexflow_tpu_torch.config import config as ffconfig
    from flexflow_tpu_torch.examples.alexnet import build_alexnet
    from flexflow_tpu_torch.examples.bert_proxy import build as build_bert
    from flexflow_tpu_torch.ffmodel import AdamOptimizer, FFModel, SGDOptimizer
    from flexflow_tpu_torch.onnx_frontend import apply_onnx_weights, from_onnx_model
    from flexflow_tpu_torch.torch_frontend import apply_torch_weights, from_torch_module
    from flexflow_tpu_torch.torch_ir import model_to_string, string_to_ff
    from flexflow_tpu_torch.utils import onnx_proto as op

    require(not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32,
            "graph: TF32 must stay off for the f32 comparisons")
    dev, host = torch.device("cuda"), torch.device("cpu")
    out: dict = {}
    _launches(reset=True)

    # (a) AlexNet
    def alexnet(batch, device, fusion=True):
        old, ffconfig.fusion = ffconfig.fusion, fusion
        try:
            ff = build_alexnet(FFModel(seed=0, device=device), batch)
            ff.compile(optimizer=AdamOptimizer(lr=1e-3))
        finally:
            ffconfig.fusion = old
        return ff

    rng = np.random.RandomState(0)
    x = rng.randn(GRAPH_CHECK_BATCH, 3, 224, 224).astype(np.float32)
    y = rng.randint(0, 10, GRAPH_CHECK_BATCH).astype(np.int32)
    gpu = alexnet(GRAPH_CHECK_BATCH, dev)
    cpu = alexnet(GRAPH_CHECK_BATCH, host)
    cpu.load_numpy(_numpy_tree(gpu.params), _numpy_tree(gpu.state))
    fg, fc = gpu.forward(x), cpu.forward(x)
    rel = _within(fg, fc, 1e-4, "graph: AlexNet logits on the card against the CPU")
    eg, ec = gpu.evaluate(x, y, batch_size=GRAPH_CHECK_BATCH), cpu.evaluate(
        x, y, batch_size=GRAPH_CHECK_BATCH)
    require(abs(eg["loss"] - ec["loss"]) <= 1e-4 * abs(ec["loss"]),
            f"graph: AlexNet evaluate loss {eg['loss']} on the card vs {ec['loss']}")
    err = np.abs(fg - fc).max()
    top2 = np.sort(fc, axis=-1)[:, -2:]
    decided = top2[:, 1] - top2[:, 0] > 2 * err
    require(bool((fg.argmax(-1) == fc.argmax(-1))[decided].all()),
            "graph: AlexNet predictions differ on a decided row")
    if decided.all():
        require(eg["accuracy"] == ec["accuracy"], "graph: AlexNet evaluate accuracy differs")
    unfused = alexnet(GRAPH_CHECK_BATCH, dev, fusion=False)
    unfused.load_numpy(_numpy_tree(gpu.params), _numpy_tree(gpu.state))
    rel_fusion = _within(unfused.forward(x), fg, 1e-4, "graph: AlexNet fusion off against on")
    require(gpu.substitution_report == cpu.substitution_report,
            f"graph: substitution report {gpu.substitution_report} vs the CPU's "
            f"{cpu.substitution_report}")
    log(f"  AlexNet 3x224x224 batch {GRAPH_CHECK_BATCH}: logits within {rel:.3g} of their "
        f"magnitude of the CPU's; evaluate loss {eg['loss']:.6f} vs {ec['loss']:.6f}, accuracy "
        f"{eg['accuracy']} vs {ec['accuracy']}; fusion off within {rel_fusion:.3g} of on; "
        f"substitutions {gpu.substitution_report} ({len(gpu._nodes)} nodes against "
        f"{len(unfused._nodes)} unfused)")
    out["alexnet_check"] = dict(rel_err=rel, loss_gpu=eg["loss"], loss_cpu=ec["loss"],
                                fusion_rel_err=rel_fusion, report=gpu.substitution_report)
    del gpu, cpu, unfused
    train = alexnet(GRAPH_TRAIN_BATCH, dev)
    xt = rng.randn(GRAPH_TRAIN_BATCH, 3, 224, 224).astype(np.float32)
    yt = rng.randint(0, 10, GRAPH_TRAIN_BATCH).astype(np.int32)
    out["alexnet"] = _graph_train(train, xt, yt, GRAPH_STEPS, GRAPH_TRAIN_BATCH, "images",
                                  f"AlexNet, Adam, batch {GRAPH_TRAIN_BATCH}", card)
    out["alexnet"]["params"] = sum(v.numel() for d in train.params.values() for v in d.values())
    del train
    torch.cuda.empty_cache()

    # (b) the BERT-large proxy
    b = BERT_LARGE

    def bert(layers, device):
        ff = build_bert(FFModel(seed=0, device=device), BERT_BATCH, b["seq"], b["hidden"],
                        b["heads"], layers)
        ff.compile(SGDOptimizer(lr=0.01))
        return ff

    xb = rng.randn(BERT_BATCH, b["seq"], b["hidden"]).astype(np.float32)
    yb = rng.randint(0, 8, BERT_BATCH).astype(np.int32)
    g2, c2 = bert(BERT_CHECK_LAYERS, dev), bert(BERT_CHECK_LAYERS, host)
    c2.load_numpy(_numpy_tree(g2.params))
    steps = {}
    for name, ff in (("gpu", g2), ("cpu", c2)):
        t0 = time.perf_counter()
        loss, _ = ff._step(ff._to_inputs([xb]), ff._to_labels(yb), None)
        steps[name] = (loss.item(), _numpy_tree(ff.params), time.perf_counter() - t0)
    (lg, pg, sg), (lc, pc, sc) = steps["gpu"], steps["cpu"]
    require(abs(lg - lc) <= 1e-4 * abs(lc), f"graph: BERT proxy loss {lg} on the card vs {lc}")
    # each layer's updated parameters against the layer's magnitude: a bias
    # starts at 0 and moves by lr x a gradient that cancels to rounding noise
    # (the value projection's, under a softmax whose rows sum to 1)
    worst = 0.0
    for k in pc:
        err = max(float(np.abs(pg[k][leaf] - pc[k][leaf]).max()) for leaf in pc[k])
        scale = max(float(np.abs(pc[k][leaf]).max()) for leaf in pc[k])
        require(err <= 1e-5 * scale, f"graph: BERT proxy {k} after one step: max |err| "
                                     f"{err:.3g} over the layer's magnitude {scale:.3g}")
        worst = max(worst, err / scale)
    log(f"  BERT-large proxy, {BERT_CHECK_LAYERS} layers, {BERT_BATCH} x {b['seq']}, one SGD "
        f"step: loss {lg:.7f} vs CPU {lc:.7f}; updated parameters within {worst:.3g} of each "
        f"layer's magnitude (card {sg:.2f} s, CPU {sc:.2f} s)")
    out["bert_check"] = dict(loss_gpu=lg, loss_cpu=lc, param_rel_err=worst)
    del g2, c2, steps, pg, pc
    deep = bert(b["layers"], dev)
    out["bert"] = _graph_train(deep, xb, yb, BERT_STEPS, BERT_BATCH * b["seq"], "tokens",
                               f"BERT-large proxy, {b['layers']} layers, SGD, "
                               f"{BERT_BATCH} x {b['seq']}", card)
    out["bert"]["params"] = sum(v.numel() for d in deep.params.values() for v in d.values())
    del deep
    torch.cuda.empty_cache()

    # (c) Keras
    (xk, yk), _ = keras.datasets.mnist.load_data(synthetic=True)
    xk = (xk.reshape(-1, 1, 28, 28) / 255.0).astype(np.float32)
    model = keras.Sequential([
        keras.Input(shape=(1, 28, 28), batch_size=64),
        keras.Conv2D(32, 3, activation="relu"), keras.MaxPooling2D(2),
        keras.Conv2D(64, 3, activation="relu"), keras.MaxPooling2D(2),
        keras.Flatten(), keras.Dense(128, activation="relu"), keras.Dense(10),
    ])
    model.compile(optimizer=keras.Adam(learning_rate=1e-3))
    require(model.ffmodel.device.type == "cuda", "graph: the Keras model is not on the card")
    t0 = time.perf_counter()
    hist = model.fit(xk, yk.astype(np.int32), batch_size=64, epochs=2)
    require(hist[-1]["loss"] < hist[0]["loss"], f"graph: Keras epoch losses did not fall: {hist}")
    out["keras"] = dict(history=hist, seconds=time.perf_counter() - t0)
    log(f"  Keras CNN on synthetic MNIST (512 x 1 x 28 x 28), Adam, 2 epochs of batch 64: "
        f"{[(round(h['loss'], 4), round(h['accuracy'], 3)) for h in hist]} in "
        f"{out['keras']['seconds']:.2f} s")
    del model

    # (d) the frontends
    gen = torch.Generator().manual_seed(0)
    torch.manual_seed(0)  # the module's initialization
    module = _residual_cnn()
    with torch.no_grad():  # running statistics that differ from the init's
        for mod in module.modules():
            if isinstance(mod, torch.nn.BatchNorm2d):
                mod.running_mean.normal_(0.0, 0.1, generator=gen)
                mod.running_var.uniform_(0.5, 1.5, generator=gen)
    module = module.to(dev).eval()
    xr = rng.randn(8, 3, 32, 32).astype(np.float32)
    ff = from_torch_module(module, [(3, 32, 32)], batch_size=8, device=dev)
    lines = model_to_string(ff)  # the serialized graph, before compile rewrites it
    ff.compile(optimizer=None)
    apply_torch_weights(ff)
    with torch.no_grad():
        want = module(torch.as_tensor(xr, device=dev)).cpu().numpy()
    got = ff.forward(xr)
    rel_fx = _within(got, want, 1e-4, "graph: the fx-imported residual CNN against the module")
    ff2 = FFModel(device=dev)
    string_to_ff(lines, ff2, [ff2.create_tensor((8, 3, 32, 32))])
    ff2.compile(optimizer=None)
    ff2.load_numpy(_numpy_tree(ff.params), _numpy_tree(ff.state))
    require(np.array_equal(ff2.forward(xr), got),
            "graph: the torch_ir round trip changed the outputs")
    r1 = np.random.RandomState(1)
    w1, b1 = r1.randn(16, 32).astype(np.float32), r1.randn(32).astype(np.float32)
    w2 = r1.randn(32, 4).astype(np.float32)
    model_proto = op.ModelProto(ir_version=8, opset_import=[op.OperatorSetIdProto(version=17)],
                                graph=op.GraphProto(
        name="mlp",
        node=[op.NodeProto(op_type="Gemm", input=["x", "w1", "b1"], output=["h"], name="fc1"),
              op.NodeProto(op_type="Relu", input=["h"], output=["hr"]),
              op.NodeProto(op_type="MatMul", input=["hr", "w2"], output=["y"], name="fc2")],
        initializer=[op.array_to_tensor(a, name=n) for n, a in
                     (("w1", w1), ("b1", b1), ("w2", w2))],
        input=[op.tensor_value_info("x", op.TensorProto.FLOAT, ("N", 16))],
        output=[op.tensor_value_info("y", op.TensorProto.FLOAT, ("N", 4))]))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "mlp.onnx")
        op.save(model_proto, path)
        fo = from_onnx_model(path, batch_size=4, device=dev)
    fo.compile(optimizer=None)
    apply_onnx_weights(fo)
    xo = r1.randn(4, 16).astype(np.float32)
    rel_onnx = _within(fo.forward(xo), np.maximum(xo @ w1 + b1, 0) @ w2, 1e-5,
                       "graph: the ONNX MLP against numpy")
    require(fo.device.type == "cuda", "graph: the ONNX model is not on the card")
    out["frontends"] = dict(fx_rel_err=rel_fx, onnx_rel_err=rel_onnx, ir_lines=len(lines))
    log(f"  frontends: fx residual CNN within {rel_fx:.3g} of the module on the card; torch_ir "
        f"round trip ({len(lines)} lines) bitwise; ONNX MLP within {rel_onnx:.3g} of numpy")
    launched = {k: v for k, v in _launches().items() if v}
    require(not launched, f"graph: the graph path launched a port kernel: {launched}")
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# the search on one device (parallel/)
# ---------------------------------------------------------------------------


def _top_k_threshold(x, k: int):
    """The cheaper exact top-k proposed for wide rows, timed beside the port's
    stable sort: ``torch.topk`` for the values and the k-th value v; the
    entries above v put in (value desc, index asc) order by two sorts of k;
    the rest of the k filled with the lowest-index entries equal to v
    (the j-th found by a binary search of the row's running count of v)."""
    import torch

    vals, idx = torch.topk(x, k, dim=-1)
    v = vals[..., -1:]
    g = (vals > v).sum(-1, keepdim=True)
    by_idx, perm = torch.sort(idx, dim=-1)
    order = torch.sort(torch.gather(vals, -1, perm), dim=-1, descending=True, stable=True).indices
    above = torch.gather(by_idx, -1, order)
    counts = torch.cumsum((x == v).to(torch.int32), dim=-1)
    j = torch.arange(1, k + 1, dtype=torch.int32, device=x.device).expand(idx.shape).contiguous()
    first_eq = torch.searchsorted(counts, j)
    slot = torch.arange(k, device=x.device).expand(idx.shape) - g
    return vals, torch.where(slot < 0, above, torch.gather(first_eq, -1, slot.clamp(min=0)))


def _plan_views(plan) -> dict:
    """A plan's sharded views by node name (replicated and source views left
    out)."""
    return {plan.nodes[j].name: v.name for j, v in sorted(plan.views.items())
            if v.name not in ("rep", "src")}


def search_phase(card: str) -> dict:
    """The joint search and the layout search on the card: (a) mlp_unify
    --full with and without ``auto_parallel``, (b) its plan over measured
    matmul costs, (c) the Trainer's layout search at 7B width against the
    cost model, (d) the C5 top-k on tied rows."""
    import numpy as np
    import torch

    from flexflow_tpu_torch.config import config as ffconfig
    from flexflow_tpu_torch.examples.mlp_unify import build as build_unify
    from flexflow_tpu_torch.ffmodel import FFModel, SGDOptimizer
    from flexflow_tpu_torch.ffmodel.substitutions import load_rules
    from flexflow_tpu_torch.models import params as params_lib
    from flexflow_tpu_torch.ops.topk import top_k
    from flexflow_tpu_torch.parallel import auto as auto_lib
    from flexflow_tpu_torch.parallel.joint import joint_optimize
    from flexflow_tpu_torch.specs import ModelSpec
    from flexflow_tpu_torch.training import AdamOptimizer, Trainer

    require(not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32,
            "search: TF32 must stay off for the f32 comparisons")
    dev, host = torch.device("cuda"), torch.device("cpu")
    out: dict = {}
    _launches(reset=True)

    # (a) mlp_unify --full without and with the joint search
    def unify(auto: bool):
        ff = build_unify(FFModel(seed=0, device=dev), UNIFY_BATCH, UNIFY_IN, list(UNIFY_HIDDEN))
        built = len(ff._nodes)
        t0 = time.perf_counter()
        ff.compile(SGDOptimizer(lr=UNIFY_LR), auto_parallel=auto)
        return ff, time.perf_counter() - t0, built

    off, off_s, built = unify(False)
    on, on_s, _ = unify(True)
    plan = on.joint_plan
    require(off.joint_plan is None and plan is not None and plan.cost < float("inf"),
            "search: compile(auto_parallel=True) kept no plan")
    on.load_numpy(_numpy_tree(off.params))
    rules = load_rules(ffconfig.substitution_json) if ffconfig.substitution_json else None
    kw = dict(n_devices=max(auto_lib.device_count(dev), 2), batch=UNIFY_BATCH, rules=rules,
              budget=ffconfig.search_budget * 4, alpha=ffconfig.search_alpha)
    fresh = build_unify(FFModel(device=dev), UNIFY_BATCH, UNIFY_IN, list(UNIFY_HIDDEN))
    t0 = time.perf_counter()
    analytic = joint_optimize(fresh._nodes, fresh._inputs, **kw)
    search_ms = 1e3 * (time.perf_counter() - t0)
    require(analytic.applied == plan.applied and analytic.cost == plan.cost,
            "search: the plan of compile() differs from joint_optimize's on the same graph")
    log(f"  mlp_unify --full ({built} nodes, batch {UNIFY_BATCH}, {UNIFY_IN} -> "
        f"{len(UNIFY_HIDDEN)} x {UNIFY_HIDDEN[0]} in both towers): fixpoint rewrites "
        f"{off.substitution_report} -> {len(off._nodes)} nodes; joint search "
        f"(n_devices {kw['n_devices']}, budget {kw['budget']}, alpha {kw['alpha']}) rewrites "
        f"{on.substitution_report} -> {len(on._nodes)} nodes, {len(plan.report)} candidates, "
        f"plan cost {plan.cost:.6g} s (analytic, H100 MachineModel), views "
        f"{_plan_views(plan)}; the search alone {search_ms:.1f} ms wall; compile "
        f"{1e3 * off_s:.0f} ms without, {1e3 * on_s:.0f} ms with")
    rng = np.random.RandomState(0)
    xs = [rng.randn(UNIFY_BATCH, UNIFY_IN).astype(np.float32) for _ in range(2)]
    y = rng.randint(0, UNIFY_HIDDEN[-1], UNIFY_BATCH).astype(np.int32)
    runs = {}
    for name, ff in (("off", off), ("on", on)):
        # the demo's signal all but vanishes through 8 bias-free layers at its
        # initialization: its loss sits at log(8192) to 6 digits for 8 steps
        runs[name] = _graph_train(ff, xs, y, UNIFY_STEPS, UNIFY_BATCH, "samples",
                                  f"mlp_unify --full, auto_parallel={name == 'on'}", card,
                                  falls=False)
    lo, ln = runs["off"]["losses"][0], runs["on"]["losses"][0]
    require(abs(ln - lo) <= 1e-5 * abs(lo), f"search: first losses {ln} with the search vs {lo}")
    out["unify"] = dict(nodes_built=built, nodes_off=len(off._nodes), nodes_on=len(on._nodes),
                        report_off=off.substitution_report, report_on=on.substitution_report,
                        candidates=len(plan.report), plan_cost_s=plan.cost,
                        views=_plan_views(plan), search_ms=search_ms, compile_ms_off=1e3 * off_s,
                        compile_ms_on=1e3 * on_s, first_loss_off=lo, first_loss_on=ln,
                        off=runs["off"], on=runs["on"])
    log(f"  mlp_unify step with / without the search: device {runs['on']['device_ms']:.3f} / "
        f"{runs['off']['device_ms']:.3f} ms, wall {runs['on']['wall_ms']:.3f} / "
        f"{runs['off']['wall_ms']:.3f} ms; first losses {ln:.9f} / {lo:.9f} [{card}]")
    del off, on, runs
    gc.collect()
    torch.cuda.empty_cache()

    # (b) the same graph's plan over matmuls timed on the card
    cache = auto_lib.OpCostCache(dev)
    t0 = time.perf_counter()
    measured = joint_optimize(fresh._nodes, fresh._inputs, cache=cache, **kw)
    measured_ms = 1e3 * (time.perf_counter() - t0)
    m = auto_lib.MachineModel()
    entries = []
    for key, sec in sorted(cache.items(), key=lambda kv: repr(kv[0])):
        _, rows, k, n = key
        model_s = 2.0 * rows * k * n / m.chip_flops + (k * n * 2) / m.hbm_bw
        entries.append(dict(key=list(key), measured_ms=1e3 * sec, analytic_ms=1e3 * model_s))
        log(f"    cache {key}: {1e3 * sec:.4f} ms measured, {1e3 * model_s:.4f} ms analytic "
            f"({sec / model_s:.1f}x)")
    va, vm = _plan_views(analytic), _plan_views(measured)
    differ = {name: (va.get(name, "rep"), vm.get(name, "rep"))
              for name in sorted(set(va) | set(vm)) if va.get(name) != vm.get(name)}
    out["measured"] = dict(entries=entries, search_ms=measured_ms, cost_s=measured.cost,
                           applied=measured.applied, analytic_applied=analytic.applied,
                           candidates=len(measured.report), views_differ=differ)
    log(f"  measured search: {len(cache)} cache entries, {len(measured.report)} candidates, "
        f"{measured_ms:.1f} ms wall (the timing included), plan cost {measured.cost:.6g} s "
        f"against the analytic plan's {analytic.cost:.6g} s; rewrites {measured.applied} vs "
        f"{analytic.applied}; views that differ (analytic, measured): {differ or 'none'} "
        f"[{card}]")
    del fresh, cache

    # (c) the Trainer's layout search at 7B width against the cost model
    spec = ModelSpec(**{**LLAMA2_7B, "num_layers": TRAIN_LAYERS})
    params = params_lib.init_params(spec, 0, torch.float32, host)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tr = Trainer(spec, params, AdamOptimizer(lr=TRAIN_LR), mesh="auto",
                 auto_batch_size=SEARCH_BATCH, auto_seq_len=SEARCH_LEN, device=dev)
    auto_s = time.perf_counter() - t0
    peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
    del params
    rep = tr.auto_report
    require(len(rep) == 1 and rep[0]["layout"] == "dp=1 pp=1 tp=1 mb=1"
            and rep[0]["measured_s"] < float("inf"), f"search: the Trainer's report {rep}")
    layout = auto_lib.Layout(1, 1, 1)
    op_cache = auto_lib.OpCostCache(dev)
    sim_s = auto_lib.simulate_runtime(spec, layout, SEARCH_BATCH, SEARCH_LEN, op_cache)
    ana_s = auto_lib.analytic_cost(layout, spec, SEARCH_BATCH, SEARCH_LEN)
    mem_gb = auto_lib.estimate_memory(layout, spec, SEARCH_BATCH, SEARCH_LEN) / 1e9
    step_s = rep[0]["measured_s"]
    batch = rng.randint(3, spec.vocab_size, (SEARCH_BATCH, SEARCH_LEN + 1)).astype(np.int32)
    losses = [tr.train_step(batch[:, :-1], batch[:, 1:]) for _ in range(3)]
    require(all(np.isfinite(losses)) and losses[-1] < losses[0],
            f"search: the chosen layout's losses {losses}")
    out["trainer"] = dict(report=rep, search_s=auto_s, step_ms=1e3 * step_s,
                          simulated_ms=1e3 * sim_s, analytic_ms=1e3 * ana_s,
                          est_mem_gb=mem_gb, peak_mem_gb=peak_gb, losses=losses,
                          cache={str(k): 1e3 * v for k, v in op_cache.items()})
    log(f"  Trainer(mesh='auto') at LLaMA-2-7B width, {TRAIN_LAYERS} layers, f32, Adam, "
        f"{SEARCH_BATCH} x {SEARCH_LEN} tokens: {rep[0]['layout']} measured {1e3 * step_s:.2f} ms a "
        f"step (the search {auto_s:.1f} s with its Trainer's build); simulate_runtime "
        f"{1e3 * sim_s:.2f} ms (bf16 ops timed on the card, {len(op_cache)} entries; "
        f"{step_s / sim_s:.2f}x), analytic_cost {1e3 * ana_s:.2f} ms ({step_s / ana_s:.2f}x); "
        f"estimate_memory {mem_gb:.2f} GB against a peak of {peak_gb:.2f} GB while searching; "
        f"the chosen layout's losses {[round(v, 4) for v in losses]} [{card}]")
    del tr, op_cache
    gc.collect()
    torch.cuda.empty_cache()

    # (d) the C5 top-k on the card against a stable host argsort
    checks = []
    for dtype in (torch.float32, torch.bfloat16):
        for rows, width, k in TOPK_CASES:
            x = np.round(rng.randn(rows, width) * 2) / 2  # halves: exact in bf16
            x[-1] = 0.5
            xt = torch.tensor(x, dtype=torch.float32, device=dev).to(dtype)
            want = np.argsort(-x, axis=-1, kind="stable")[:, :k]
            for form, fn in (("top_k", top_k), ("threshold", _top_k_threshold)):
                vals, idx = fn(xt, k)
                require(np.array_equal(idx.cpu().numpy(), want)
                        and np.array_equal(vals.float().cpu().numpy(),
                                           np.take_along_axis(x, want, -1)),
                        f"search: {form} on the card, {dtype} [{rows}, {width}]")
            rows_apart = int((torch.topk(xt, k).indices.cpu().numpy() != want).any(-1).sum())
            ms = time_ms(lambda: top_k(xt, k), reps=50)
            threshold_ms = time_ms(lambda: _top_k_threshold(xt, k), reps=50)
            plain_ms = time_ms(lambda: torch.topk(xt, k), reps=50)
            checks.append(dict(dtype=str(dtype).replace("torch.", ""), rows=rows, width=width,
                               k=k, ms=ms, threshold_ms=threshold_ms, topk_ms=plain_ms,
                               topk_rows_apart=rows_apart))
            log(f"  C5 top_k {str(dtype).replace('torch.', '')} [{rows}, {width}] k={k}: "
                f"indices equal a stable host argsort on every row (the threshold form's "
                f"too); stable sort {ms:.4f} ms, threshold form {threshold_ms:.4f} ms, "
                f"torch.topk {plain_ms:.4f} ms, whose indices differ on {rows_apart} of "
                f"{rows} rows [{card}]")
    out["topk"] = checks
    launched = {k: v for k, v in _launches().items() if v}
    require(not launched, f"search: the search path launched a port kernel: {launched}")
    return out


# ---------------------------------------------------------------------------
# tensor and data parallelism (parallel/mesh.py, parallel/sharding.py)
# ---------------------------------------------------------------------------

TP_MIXTRAL_LAYERS = 2  # (e)'s depth at Mixtral-8x7B's full width (cut from 4 for time)
# (d)'s verifier depth at LLaMA-2-7B's full width: 32 layers took 77-100 s of
# the phase over gloo; the draft's 12 (the block-embedding needs at least the
# draft's depth) keep the cut, the tree and the prefix gate
TP_SPEC_LAYERS = 12
TP_SPEC_NEW = 24  # (d)'s new tokens a request, both runs (cut from 64 for the run's time)
# (b), (e): the T-rank prefill's last-position logits against one device's,
# max |difference| over the largest |logit|: both round every layer's output
# to bf16 once, from f32 sums of the same products in another order (the
# one-device K1 call against T partial calls summed by the all-reduce)
TP_LOGITS_REL = 5e-2
_SERVED: dict = {}  # the serve phase's tokens and decode tok/s, for the tp phase


def _greedy_scfg(n: int):
    import numpy as np

    from flexflow_tpu_torch.ops.sampling import SamplingConfig

    return SamplingConfig(temperature=np.zeros(n, np.float32), top_p=np.ones(n, np.float32),
                          top_k=np.zeros(n, np.int32))


def _prefill_logits(engine, spec, prompts, adapters=None):
    """Last-position float32 logits [N, V] of one batched prefill forward of
    ``prompts`` through the engine's parameters (its rank's cut) at its
    bucket (no cache write), request i through LoRA adapter
    ``adapters[i]`` (default none), on the host; and the greedy first
    tokens of a real admission into slots 0..N-1."""
    import numpy as np
    import torch

    from flexflow_tpu_torch.models import decoder

    n = len(prompts)
    bucket = max(engine.prefill_bucket(len(p)) for p in prompts)
    padded = np.zeros((n, bucket), np.int32)
    for i, p in enumerate(prompts):
        padded[i, :len(p)] = p
    dev = engine.device
    lens = torch.tensor([len(p) for p in prompts], dtype=torch.int32, device=dev)
    positions = torch.arange(bucket, dtype=torch.int32, device=dev)[None].expand(n, bucket)
    routing = engine._routing(engine._adapter_ids(adapters, n))
    with torch.no_grad():
        logits, _ = decoder.forward(spec, engine.params, torch.as_tensor(padded, device=dev),
                                    positions, lengths=lens, flash=True, logits_at=lens - 1,
                                    **routing)
        first = engine.prefill_batch_to_slots_async(prompts, list(range(n)), 0,
                                                    _greedy_scfg(n), adapter_ids=adapters)[:n]
    return logits.float().cpu(), first.cpu().tolist()


def _first_token_rule(what: str, got_logits, want_logits, got_first, want_first,
                      limit: float = None) -> dict:
    """Logits within ``limit`` (default ``TP_LOGITS_REL``) of their magnitude, and every
    request's first token equal to one device's; the near-tie rows (top-2
    margin within twice the observed error), which the logits alone would
    not decide, are counted and reported."""
    import torch

    limit = TP_LOGITS_REL if limit is None else limit
    err = (got_logits - want_logits).abs().max().item()
    scale = want_logits.abs().max().item()
    require(err <= limit * scale,
            f"{what}: prefill logits max|diff| {err} > {limit} x {scale}")
    top2 = torch.topk(want_logits, 2, dim=-1).values
    margin = top2[:, 0] - top2[:, 1]
    near = int((margin <= 2 * err).sum())
    apart = [i for i, (g, w) in enumerate(zip(got_first, want_first)) if g != w]
    require(not apart,
            f"{what}: first tokens {got_first} against one device's {want_first}: rows {apart} "
            f"differ, one device's top-2 margins there {[round(margin[i].item(), 5) for i in apart]} "
            f"against the logits' max|diff| {err:.5g}")
    log(f"  {what}: prefill logits max|diff| {err:.4g} ({err / scale:.3g} of the largest "
        f"|logit|, limit {limit}); every request's first token equal to one device's "
        f"({len(want_first)} of {len(want_first)}), {near} of them on near-tie rows (top-2 "
        f"margin within 2x the error)")
    return dict(logits_max_abs_diff=err, logits_scale=scale, first_equal=len(want_first),
                near_ties=near)


def _common_prefix(got, want) -> list:
    return [next((j for j in range(len(a)) if a[j] != b[j]), len(a)) for a, b in zip(got, want)]


def _tp_llama(mesh, dev):
    """LLaMA-2-7B INT8 (group 128) on this rank of ``mesh``: the serve
    phase's draw (``_quant_params``), each layer's slab quantized whole and
    then cut (``build_params(mesh=)``), so each rank's carriers are slices
    of the one-device carriers at any degree (a row cut inside a group
    keeps the group's scale). Layer by layer, two ranks' builds fit the
    card together (a whole-tree quantization on each does not)."""
    import torch

    from flexflow_tpu_torch.models import params as params_lib
    from flexflow_tpu_torch.serving.engine import InferenceEngine
    from flexflow_tpu_torch.serving.request_manager import RequestManager
    from flexflow_tpu_torch.specs import ModelSpec

    spec = ModelSpec(**LLAMA2_7B)
    gen = torch.Generator(device=dev).manual_seed(0)
    whole = params_lib.init_params(spec, gen, torch.bfloat16, dev)
    layers = whole.pop("layers")
    params = params_lib.build_params(spec, whole, lambda i: ((n, v[i]) for n, v in layers.items()),
                                     dtype=torch.bfloat16, device=dev, bits=8, group_size=128,
                                     mesh=mesh)
    del whole, layers
    torch.cuda.empty_cache()
    engine = InferenceEngine(spec, params, max_requests_per_batch=8, max_seq_len=1024,
                             max_tokens_per_batch=0, cache_dtype=torch.bfloat16, device=dev,
                             mesh=mesh)
    del params
    torch.cuda.empty_cache()
    return spec, engine, RequestManager(engine, decode_horizon=16, pipelined=True)


def _tp_case_b(mesh, dev, refs) -> dict:
    """(b): T ranks, each with its cut of the model: the prefill's logits
    and first tokens (the dist phase's (a) serves the traffic on this cut)."""
    spec, engine, rm = _tp_llama(mesh, dev)
    rm.close()
    logits, first = _prefill_logits(engine, spec, _prompts(spec.vocab_size))
    return dict(logits=logits, first=first)


def _tp_case_c(mesh, dev, refs) -> dict:
    """(c): D ranks, each with the whole model and its block of slots."""
    spec, engine, rm = _tp_llama(mesh, dev)
    try:
        reqs, st = _served(rm, _prompts(spec.vocab_size), 64, spec.vocab_size,
                           f"tp (c) D={mesh.data}", replayed=engine.graphs is not None)
        st["tokens"] = [r.output_tokens for r in reqs]
    finally:
        rm.close()
    return st


def _tp_case_d(mesh, dev, refs) -> dict:
    """(d): the spec phase's INT4 verifier (cut to TP_SPEC_LAYERS layers)
    and 160M draft at T ranks, the speculative run and the incremental run
    of the same cut."""
    import torch

    from flexflow_tpu_torch.config import config as ffconfig
    from flexflow_tpu_torch.models import params as params_lib
    from flexflow_tpu_torch.parallel.sharding import shard_params
    from flexflow_tpu_torch.serving.engine import InferenceEngine
    from flexflow_tpu_torch.serving.request_manager import RequestManager
    from flexflow_tpu_torch.serving.spec_manager import SpecRequestManager
    from flexflow_tpu_torch.serving.speculative import SpecEngine, tree_size
    from flexflow_tpu_torch.specs import ModelSpec
    from flexflow_tpu_torch.utils.spec_pair import embed_draft_in_verifier

    dspec = ModelSpec(**DRAFT_160M)
    vspec = ModelSpec(**{**LLAMA2_7B, "num_layers": TP_SPEC_LAYERS})
    dparams = params_lib.init_params(dspec, torch.Generator(device=dev).manual_seed(0),
                                     torch.bfloat16, dev)
    # the block-embedding builds the whole verifier (a harness shortcut:
    # the loaders cut as they build); cut at once, the whole tree freed
    vparams = shard_params(vspec, embed_draft_in_verifier(
        dspec, dparams, vspec, bits=4, group_size=128, dtype=torch.bfloat16, device=dev), mesh)
    dparams = shard_params(dspec, dparams, mesh)
    torch.cuda.empty_cache()
    width, depth, seq = 3, 4, 1024
    horizon = max(1, min(ffconfig.spec_horizon, seq // (4 * (tree_size(width, depth) + 1))))
    prompts = _prompts(vspec.vocab_size)
    engine = SpecEngine(vspec, vparams, dspec, dparams, beam_width=width, beam_depth=depth,
                        max_requests_per_batch=8, max_seq_len=seq, cache_dtype=torch.bfloat16,
                        device=dev, mesh=mesh)
    managers = [SpecRequestManager(engine, fused=True, spec_horizon=horizon,
                                   pipelined=horizon > 1, pipeline_depth=ffconfig.pipeline_depth)
                for _ in range(2)]
    spec_reqs, st = _served(managers[1], prompts, TP_SPEC_NEW, vspec.vocab_size,
                            f"tp (d) speculative T={mesh.model}", warm=managers[0],
                            replayed=engine.graphs is not None)
    st["mean_verified_tokens_per_step"] = managers[1].mean_verified_tokens_per_step
    del managers, engine
    torch.cuda.empty_cache()
    engine = InferenceEngine(vspec, vparams, max_requests_per_batch=8, max_seq_len=seq,
                             max_tokens_per_batch=0, cache_dtype=torch.bfloat16, device=dev,
                             mesh=mesh)
    rm = RequestManager(engine, decode_horizon=16, pipelined=True)
    try:
        incr_reqs, incr = _served(rm, prompts, TP_SPEC_NEW, vspec.vocab_size,
                                  f"tp (d) incremental T={mesh.model}",
                                  replayed=engine.graphs is not None)
    finally:
        rm.close()
    st["incremental"] = incr
    st["spec_tokens"] = [r.output_tokens for r in spec_reqs]
    st["incr_tokens"] = [r.output_tokens for r in incr_reqs]
    return st


def _tp_case_e(mesh, dev, refs) -> dict:
    """(e): Mixtral-8x7B INT8 at TP_MIXTRAL_LAYERS layers, built layer by
    layer, each slab quantized whole and then cut
    (``init_quantized_params(mesh=)``); its prefill against one device's at
    that depth."""
    import torch

    from flexflow_tpu_torch.models import params as params_lib
    from flexflow_tpu_torch.serving.engine import InferenceEngine

    spec = mixtral_spec(TP_MIXTRAL_LAYERS)
    params = params_lib.init_quantized_params(spec, 0, bits=8, group_size=128,
                                              dtype=torch.bfloat16, device=dev, mesh=mesh)
    engine = InferenceEngine(spec, params, max_requests_per_batch=8, max_seq_len=1024,
                             max_tokens_per_batch=0, cache_dtype=torch.bfloat16, device=dev,
                             mesh=mesh)
    del params
    logits, first = _prefill_logits(engine, spec, _prompts(spec.vocab_size))
    return dict(logits=logits, first=first)


TP_CASES = {"b": _tp_case_b, "c": _tp_case_c, "d": _tp_case_d, "e": _tp_case_e}


def _tp_rank(rank: int, world: int, backend: str, tmp: str, cases) -> None:
    """One rank of the tp, meshtrain, layouts, pp, pptrain and cp phases' spawned cases:
    ``backend`` gloo shares card 0, NCCL takes card ``rank``. Each case
    builds its own mesh over the group (all ranks on ``data`` for (c),
    meshtrain's (c) and layouts' (b), on ``pipe`` for pp's and pptrain's, on
    ``seq`` for cp's (a)-(h), two stages by ``world / 2`` seq ranks for cp's
    (i) and (j), none for the layout searches' cases, which build each
    candidate's, else on ``model``); the results go to ``tmp`` for the
    parent to hold against one device."""
    import torch
    import torch.distributed as dist

    from flexflow_tpu_torch.parallel.mesh import make_mesh

    dev = torch.device("cuda", rank if backend == "nccl" else 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if rank:
        global log
        log = lambda *a: None  # noqa: E731 - rank 0 speaks for the mesh
    dist.init_process_group(backend, init_method=f"file://{tmp}/rendezvous-{backend}",
                            world_size=world, rank=rank)
    try:
        out = {}
        for case in cases:
            t0 = time.perf_counter()
            degrees = (dict(data=world) if case in ("c", "mt-c", "la-b") else
                       dict(pipe=world) if case in {**PP_CASES, **PT_CASES} else
                       dict(seq=world) if case in CP_CASES else
                       dict(pipe=2, seq=world // 2) if case in CP_PP_CASES else
                       dict(model=world))
            # the search cases build their own meshes (every candidate's)
            mesh = None if case in SM_CASES else make_mesh(**degrees, backend=backend, device=dev)
            out[case] = {**TP_CASES, **MT_CASES, **SM_CASES, **LA_CASES, **PP_CASES, **PT_CASES,
                         **CP_CASES, **CP_PP_CASES}[case](mesh, dev, None)
            out[case]["seconds"] = time.perf_counter() - t0
            gc.collect()
            torch.cuda.empty_cache()
        torch.save(out, f"{tmp}/{backend}.{rank}.pt")
    finally:
        dist.destroy_process_group()


def _spawn_tp(world: int, backend: str, tmp: str, cases, limit_s: float) -> list:
    """Every rank's results of ``cases`` (ranks spawned; killed at ``limit_s``)."""
    import torch
    import torch.multiprocessing as mp

    ctx = mp.start_processes(_tp_rank, args=(world, backend, tmp, list(cases)), nprocs=world,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + limit_s
    try:
        while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
            require(time.monotonic() < deadline,
                    f"tp: {world} {backend} ranks did not finish within {limit_s} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    return [torch.load(f"{tmp}/{backend}.{r}.pt", weights_only=False) for r in range(world)]


def tp_phase(card: str) -> dict:
    """Tensor and data parallel serving (see the module docstring, phase
    tp): (a) one rank over NCCL through the sharded path in this process;
    then two ranks sharing the card over gloo for (b)-(e), spawned; (f) NCCL
    across GPUs when the machine has more than one."""
    import torch
    import torch.distributed as dist

    from flexflow_tpu_torch.models import params as params_lib
    from flexflow_tpu_torch.parallel.mesh import make_mesh
    from flexflow_tpu_torch.parallel.sharding import shard_params
    from flexflow_tpu_torch.serving.engine import InferenceEngine
    from flexflow_tpu_torch.serving.request_manager import RequestManager
    from flexflow_tpu_torch.specs import ModelSpec

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    spec = ModelSpec(**LLAMA2_7B)
    prompts = _prompts(spec.vocab_size)
    out: dict = {"card": card}
    params = _quant_params(spec, 0, dev)
    if "tokens" not in _SERVED:  # the serve phase did not run: its run here
        engine = InferenceEngine(spec, params, max_requests_per_batch=8, max_seq_len=1024,
                                 max_tokens_per_batch=0, cache_dtype=torch.bfloat16, device=dev)
        rm = RequestManager(engine, decode_horizon=16, pipelined=True)
        try:
            reqs, st = _served(rm, prompts, 64, spec.vocab_size, "tp one device")
        finally:
            rm.close()
        _SERVED.update(tokens=[r.output_tokens for r in reqs], decode_tok_s=st["decode_tok_s"],
                       mean_ttft_ms=st["mean_ttft_ms"])
        del engine, rm
        torch.cuda.empty_cache()

    # (a) one rank over NCCL, through the sharded path: collectives in the graphs
    mesh = make_mesh(model=1, device=dev)
    require(mesh.backend == "nccl", f"tp (a): backend {mesh.backend}, not nccl")
    engine = InferenceEngine(spec, shard_params(spec, params, mesh), max_requests_per_batch=8,
                             max_seq_len=1024, max_tokens_per_batch=0,
                             cache_dtype=torch.bfloat16, device=dev, mesh=mesh)
    del params
    require(engine.graphs is not None, "tp (a): an NCCL mesh engine captures its step")
    rm = RequestManager(engine, decode_horizon=16, pipelined=True)
    try:
        reqs, st = _served(rm, prompts, 64, spec.vocab_size, "tp (a) world 1 over NCCL")
        require([r.output_tokens for r in reqs] == _SERVED["tokens"],
                "tp (a): tokens differ from the one-device run's")
        ref_logits, ref_first = _prefill_logits(engine, spec, prompts)
    finally:
        rm.close()
    out["a"] = st
    _log_served("tp (a) world 1 over NCCL", st, card)
    log(f"  tp (a): tokens bitwise equal to the one-device run's; decode {st['decode_tok_s']:.1f} "
        f"tok/s against one device's {_SERVED['decode_tok_s']:.1f} [{card}]")
    del engine, rm
    gc.collect()
    torch.cuda.empty_cache()
    dist.destroy_process_group()

    # Mixtral's one-device prefill at (e)'s depth
    mspec = mixtral_spec(TP_MIXTRAL_LAYERS)
    mparams = params_lib.init_quantized_params(mspec, 0, bits=8, group_size=128,
                                               dtype=torch.bfloat16, device=dev)
    engine = InferenceEngine(mspec, mparams, max_requests_per_batch=8, max_seq_len=1024,
                             max_tokens_per_batch=0, cache_dtype=torch.bfloat16, device=dev)
    del mparams
    mix_logits, mix_first = _prefill_logits(engine, mspec, prompts)
    del engine
    gc.collect()
    torch.cuda.empty_cache()

    tmp = tempfile.mkdtemp(prefix="chip_smoke_tp_")
    t0 = time.perf_counter()
    try:
        ranks = _spawn_tp(2, "gloo", tmp, "bcde", 900)
        n = torch.cuda.device_count()
        nccl = _spawn_tp(min(4, n), "nccl", tmp, "b", 600)[0]["b"] if n > 1 else None
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["ranks_s"] = time.perf_counter() - t0
    r0 = ranks[0]
    for case in "bcde":
        for r in ranks[1:]:
            for key in ("tokens", "first", "spec_tokens", "incr_tokens"):
                require(r[case].get(key) == r0[case].get(key),
                        f"tp ({case}): ranks disagree on {key}")
    b = r0["b"]
    out["b"] = dict(_first_token_rule("tp (b) T=2 over gloo", b["logits"], ref_logits,
                                      b["first"], ref_first), seconds=b["seconds"])
    log(f"  tp (b) T=2 over gloo: {b['seconds']:.1f} s with the weights' build")
    c = r0["c"]
    require(c["tokens"] == _SERVED["tokens"], "tp (c) D=2: tokens differ from one device's")
    out["c"] = dict(decode_tok_s=c["decode_tok_s"], launches=c["launches"], seconds=c["seconds"])
    log(f"  tp (c) D=2 over gloo: every request's 64 tokens bitwise equal to one device's; "
        f"{c['seconds']:.1f} s")
    d = r0["d"]
    same = _common_prefix(d["spec_tokens"], d["incr_tokens"])
    require(min(same) >= PREFIX,
            f"tp (d): speculative output differs from incremental within {PREFIX} tokens: {same}")
    out["d"] = dict(prefix=same, mean_verified=d["mean_verified_tokens_per_step"],
                    launches=d["launches"], incremental_launches=d["incremental"]["launches"],
                    seconds=d["seconds"])
    log(f"  tp (d) INT4 verifier + 160M draft at T=2 over gloo: speculative tokens equal to the "
        f"same cut's incremental ones before the first difference, per request: {same}; "
        f"mean verified tokens per step {d['mean_verified_tokens_per_step']:.3f}; "
        f"{d['seconds']:.1f} s")
    e = r0["e"]
    out["e"] = _first_token_rule(f"tp (e) Mixtral-8x7B INT8 {TP_MIXTRAL_LAYERS} layers T=2 over "
                                 "gloo", e["logits"], mix_logits, e["first"], mix_first)
    out["e"]["seconds"] = e["seconds"]
    if nccl is not None:
        f = nccl
        out["f"] = dict(_first_token_rule(f"tp (f) T={min(4, n)} over NCCL", f["logits"],
                                          ref_logits, f["first"], ref_first),
                        seconds=f["seconds"])
    else:
        log(f"  tp (f) did not run: the machine shows {n} GPU (NCCL takes one device a rank)")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"  tp phase wall {out['seconds']:.1f} s, the spawned ranks' {out['ranks_s']:.1f} s of "
        f"it [{card}]")
    return out


# ---------------------------------------------------------------------------
# gradients and adapters over a mesh (the meshtrain phase)
# ---------------------------------------------------------------------------

MT_STEPS = 3  # Trainer steps a case
MT_RANK_LAYERS = 1  # (b), (c): the train phase's width, one layer (time)
MT_SGD_LR = 1e-2
# (a): one NCCL rank's losses against one device's: bitwise, or within this
# relative bound (the rank's row-parallel wo / wd products are f32 tensordots
# where one device runs an einsum / a tensordot in the activations' dtype:
# cuBLAS may sum them in another order)
MT_ONE_RANK_REL = 1e-5
MT_LORA_LAYERS = 2  # (d), (e): LLaMA-2-7B INT8, full width (cut from 4 for time)
MT_LORA_LOGITS_REL = 2e-2
# (d), (e) run f32 activations and an f32 KV cache over the INT8 carriers (the
# kernels take f32): at bf16 T = 2 and one device round every layer's output
# from f32 sums in another order, and two of the eight first tokens parted at
# rows whose top-2 margin lies within twice the logits' difference (which any
# flip must), so equality there decides nothing about the port
MT_LORA_DTYPE = "float32"
MT_FT_SLOT, MT_FT_STEPS, MT_FT_LR = 3, 2, 1e-3
MT_LORA_NEW = 32  # (d): new tokens a request (cut from the serve traffic's 64 for the run's time)


def _mt_batch(vocab_size: int):
    """The train phase's shape of batch: TRAIN_BATCH x TRAIN_LEN seeded tokens."""
    import numpy as np

    batch = np.random.default_rng(11).integers(3, vocab_size, (TRAIN_BATCH, TRAIN_LEN + 1))
    batch = batch.astype(np.int32)
    return batch[:, :-1], batch[:, 1:]


def _mt_trainer_run(tr, bx, by) -> tuple:
    """MT_STEPS steps; (losses, each step's wall ms)."""
    losses, ms = [], []
    for _ in range(MT_STEPS):
        t0 = time.perf_counter()
        losses.append(tr.train_step(bx, by))  # a float: the step has finished
        ms.append(1e3 * (time.perf_counter() - t0))
    return losses, ms


def _mt_train(mesh, dev, refs) -> dict:
    """(b) / (c): the Trainer at MT_RANK_LAYERS layer over ``mesh`` (T or D
    ranks), SGD; every gradient all-reduce timed (synchronized around it).
    Rank 0 then runs the one-device Trainer from the same parameters and
    holds the gathered ``full_params()`` against it."""
    import torch

    from flexflow_tpu_torch.models import params as params_lib
    from flexflow_tpu_torch.specs import ModelSpec
    from flexflow_tpu_torch.training import SGDOptimizer, Trainer
    from flexflow_tpu_torch.training import trainer as trainer_mod

    spec = ModelSpec(**{**LLAMA2_7B, "num_layers": MT_RANK_LAYERS})
    params = params_lib.init_params(spec, torch.Generator(device=dev).manual_seed(0),
                                    torch.float32, dev)
    bx, by = _mt_batch(spec.vocab_size)
    spent, nbytes = [], [0]
    reduce_grads = trainer_mod.all_reduce_grads

    def timed(grads, mesh_, axis):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reduce_grads(grads, mesh_, axis)
        torch.cuda.synchronize()
        spent.append(1e3 * (time.perf_counter() - t0))
        nbytes[0] = sum(4 * g.numel() for g in grads)

    trainer_mod.all_reduce_grads = timed
    try:
        tr = Trainer(spec, params, SGDOptimizer(lr=MT_SGD_LR), mesh=mesh)
        losses, step_ms = _mt_trainer_run(tr, bx, by)
    finally:
        trainer_mod.all_reduce_grads = reduce_grads
    full = tr.full_params()  # a collective: every rank gathers
    del tr
    torch.cuda.empty_cache()
    out = dict(losses=losses, step_ms=step_ms, allreduce_ms=spent, allreduce_bytes=nbytes[0])
    if mesh.rank == 0:
        ref = Trainer(spec, params, SGDOptimizer(lr=MT_SGD_LR), device=dev)
        out["ref_losses"], out["ref_step_ms"] = _mt_trainer_run(ref, bx, by)
        worst, worst_leaf = 0.0, ""
        for (name, got), (_, want) in zip(_param_leaves(full), _param_leaves(ref.params)):
            rel = ((got - want.detach()).abs().max() / want.detach().abs().max()).item()
            if rel > worst:
                worst, worst_leaf = rel, name
        out.update(params_rel=worst, params_worst_leaf=worst_leaf)
        del ref
    del full, params
    torch.cuda.empty_cache()
    return out


def _mt_lora_model(mesh, dev):
    """LLaMA-2-7B INT8 at MT_LORA_LAYERS layers in MT_LORA_DTYPE (this
    rank's cut with a mesh: each layer's slab quantized whole, then cut)
    and the lora phase's 4 adapters on the seven projections (SGD at
    MT_FT_LR for slot MT_FT_SLOT). Returns (spec, engine, lora config)."""
    import torch

    from flexflow_tpu_torch.models import params as params_lib
    from flexflow_tpu_torch.serving.engine import InferenceEngine
    from flexflow_tpu_torch.specs import ModelSpec

    spec = ModelSpec(**{**LLAMA2_7B, "num_layers": MT_LORA_LAYERS})
    dtype = getattr(torch, MT_LORA_DTYPE)
    whole = params_lib.init_params(spec, torch.Generator(device=dev).manual_seed(0), dtype, dev)
    layers = whole.pop("layers")
    params = params_lib.build_params(spec, whole, lambda i: ((n, v[i]) for n, v in layers.items()),
                                     dtype=dtype, device=dev, bits=8, group_size=128, mesh=mesh)
    del whole, layers
    lora, cfg = _lora_adapters(spec, 4, dev, seed=1, lr=MT_FT_LR)
    engine = InferenceEngine(spec, params, max_requests_per_batch=8, max_seq_len=1024,
                             max_tokens_per_batch=0, cache_dtype=dtype, device=dev,
                             mesh=mesh, lora=lora, lora_config=cfg)
    del params, lora
    torch.cuda.empty_cache()
    return spec, engine, cfg


def _mt_slot(engine, spec) -> dict:
    """Adapter slot MT_FT_SLOT as the engine holds it, whole (gathered over
    the model ranks under a mesh), on the host: {mod: {"a", "b"}}."""
    from flexflow_tpu_torch.parallel.sharding import gather_lora
    from flexflow_tpu_torch.peft.lora import unroute_lora

    stacks = unroute_lora(engine.lora)
    if engine.shard is not None:
        stacks = gather_lora(spec, stacks, engine.shard)
    return {m: {k: v[:, MT_FT_SLOT].float().cpu() for k, v in ab.items()}
            for m, ab in stacks.items()}


def _mt_lora(mesh, dev, refs) -> dict:
    """(d) + (e): the LoRA model over ``mesh``: the routed prefill's logits
    and first tokens, then the serve traffic routed LORA_IDS with a
    finetuning session on slot MT_FT_SLOT registered beside it; its losses
    and the gathered slot."""
    from flexflow_tpu_torch.peft.finetune import FinetuneSession
    from flexflow_tpu_torch.serving.request_manager import RequestManager

    spec, engine, cfg = _mt_lora_model(mesh, dev)
    prompts = _prompts(spec.vocab_size)
    out = {}
    out["logits"], out["first"] = _prefill_logits(engine, spec, prompts, adapters=LORA_IDS)
    session = FinetuneSession(spec, cfg, MT_FT_SLOT,
                              _finetune_data(spec.vocab_size)[:MT_FT_STEPS], epochs=1)
    rm = RequestManager(engine, decode_horizon=16, pipelined=True)
    try:
        reqs, st = _served(rm, prompts, MT_LORA_NEW, spec.vocab_size,
                           f"meshtrain (d) LoRA T={mesh.model} with (e)'s finetuning",
                           adapters=LORA_IDS, session=session,
                           replayed=engine.graphs is not None)
    finally:
        rm.close()
    out.update(st, losses=session.losses, slot=_mt_slot(engine, spec))
    return out


MT_CASES = {"mt-b": _mt_train, "mt-c": _mt_train, "mt-d": _mt_lora}

# the layout searches over the two ranks (search (e)-(g), in meshtrain's spawn)
# (f): mlp_unify's CLI at --full (957 M f32), one epoch (4 steps) after the search
SM_UNIFY_ARGS = ["--auto-parallelism", "--full", "--epochs", "1"]
SM_LLM_LAYERS = 4  # (g): LLaMA-2-7B width, bf16
SM_LLM_NEW = 32  # (g): new tokens a request (the serve prompts)


def _sm_trainer(mesh, dev, refs) -> dict:
    """search (e): ``Trainer(mesh="auto")`` over the ranks at LLaMA-2-7B
    width, ``MT_RANK_LAYERS`` layer, f32, SGD, searched at the train
    phase's ``TRAIN_BATCH`` x ``TRAIN_LEN``; then one step on the meshtrain
    batch beside a fresh ``Trainer(mesh=make_mesh(<chosen>))``'s: its loss
    and this rank's parameters after it, bitwise."""
    import torch

    from flexflow_tpu_torch.models import params as params_lib
    from flexflow_tpu_torch.parallel.mesh import make_mesh
    from flexflow_tpu_torch.specs import ModelSpec
    from flexflow_tpu_torch.training import SGDOptimizer, Trainer

    spec = ModelSpec(**{**LLAMA2_7B, "num_layers": MT_RANK_LAYERS})
    params = params_lib.init_params(spec, torch.Generator(device=dev).manual_seed(0),
                                    torch.float32, dev)
    bx, by = _mt_batch(spec.vocab_size)
    t0 = time.perf_counter()
    tr = Trainer(spec, params, SGDOptimizer(lr=MT_SGD_LR), mesh="auto",
                 auto_batch_size=TRAIN_BATCH, auto_seq_len=TRAIN_LEN, device=dev)
    search_s = time.perf_counter() - t0
    m, report = tr.mesh, tr.auto_report
    chosen = (m.data, m.pipe, m.model)
    loss = tr.train_step(bx, by)
    fresh = Trainer(spec, params, SGDOptimizer(lr=MT_SGD_LR), mesh=make_mesh(*chosen, device=dev),
                    pipeline_stages=m.pipe, num_microbatches=tr.num_microbatches)
    want = fresh.train_step(bx, by)
    mine, theirs = dict(_param_leaves(tr.params)), dict(_param_leaves(fresh.params))
    same = sorted(mine) == sorted(theirs) and all(
        torch.equal(mine[k].detach(), theirs[k].detach()) for k in mine)
    for t in (tr, fresh):
        t.mesh.release()
    del tr, fresh, params, mine, theirs
    gc.collect()
    torch.cuda.empty_cache()
    return dict(report=report, chosen=chosen, search_s=search_s, loss=loss, fresh_loss=want,
                params_bitwise=same)


def _sm_unify(mesh, dev, refs) -> dict:
    """search (f): mlp_unify's CLI (``SM_UNIFY_ARGS``) over the ranks: its
    FFModel's measured (data, model) search at the first batch, then the
    epoch under the chosen cut; the report and the cut recorded."""
    import contextlib
    import io

    from flexflow_tpu_torch.examples import mlp_unify
    from flexflow_tpu_torch.ffmodel import model as ff_model

    seen = []
    search = ff_model.FFModel._auto_parallelize

    def recorded(self, *a, **k):
        t0 = time.perf_counter()
        search(self, *a, **k)
        seen.append(dict(report=self.auto_report, seconds=time.perf_counter() - t0,
                         cut=(self._cut.mesh.data, self._cut.mesh.model, sorted(self._cut.views))))

    ff_model.FFModel._auto_parallelize = recorded
    text = io.StringIO()
    try:
        with contextlib.redirect_stdout(text):
            hist = mlp_unify.main(list(SM_UNIFY_ARGS))
    finally:
        ff_model.FFModel._auto_parallelize = search
    [rec] = seen
    return dict(rec, losses=[h["loss"] for h in hist], text=text.getvalue())


def _sm_llm_class():
    """``LLM`` over LLaMA-2-7B width at ``SM_LLM_LAYERS`` layers, bf16, its
    weights drawn from seed 0 on the device (no checkpoint is in the
    repository) and cut for this rank's mesh, with the id tokenizer."""
    import torch

    from flexflow_tpu_torch.models import params as params_lib
    from flexflow_tpu_torch.parallel.sharding import shard_params
    from flexflow_tpu_torch.serve import LLM
    from flexflow_tpu_torch.specs import ModelSpec

    class RandomLLM(LLM):
        def __init__(self, device):
            self.device, self.model_dir, self.dtype = device, "<seed 0>", torch.bfloat16
            self.quant_bits, self.output_file = None, ""
            self.spec = ModelSpec(**{**LLAMA2_7B, "num_layers": SM_LLM_LAYERS})
            self.params, self.tokenizer, self.rm = None, IdTokenizer(), None
            self._ssms, self._peft, self.lora, self.lora_config = [], [], None, None

        def _load_params(self, host_layers=False, mesh=None):
            gen = torch.Generator(device=self.device).manual_seed(0)
            whole = params_lib.init_params(self.spec, gen, torch.bfloat16, self.device)
            return whole if mesh is None else shard_params(self.spec, whole, mesh)

        def _load_tokenizer(self):
            pass

    return RandomLLM


def _sm_serve(llm, what: str) -> dict:
    """The serve prompts x SM_LLM_NEW through ``llm`` (compiled): tokens,
    launches, decode rate."""
    import torch

    prompts = _prompts(llm.spec.vocab_size)
    llm.generate([prompts[-1]], max_new_tokens=4)  # warm-up (graphs, buckets)
    torch.cuda.synchronize()
    _launches(reset=True)
    t0 = time.perf_counter()
    res = llm.generate(prompts, max_new_tokens=SM_LLM_NEW)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return dict(tokens=[r.output_tokens for r in res], launches=_launches(), wall_s=wall,
                tok_s=sum(len(r.output_tokens) for r in res) / wall, what=what)


def _sm_llm(mesh, dev, refs) -> dict:
    """search (g): ``LLM.compile(auto_parallel=True)`` over the ranks (the
    serving search on a seeded probe of the spec: the TP x PP candidates,
    each an engine timed on a decode step), then the serve prompts x
    ``SM_LLM_NEW`` tokens under the chosen degrees."""
    import torch

    t0 = time.perf_counter()
    llm = _sm_llm_class()(dev)
    llm.compile(max_requests_per_batch=8, max_seq_length=1024, max_tokens_per_batch=1024,
                auto_parallel=True)
    compile_s = time.perf_counter() - t0
    m = llm.mesh
    out = dict(_sm_serve(llm, "search (g)"), report=llm.auto_report, compile_s=compile_s,
               degrees=None if m is None else (m.data, m.pipe, m.model))
    llm.rm.close()
    if m is not None:
        m.release()
    del llm
    gc.collect()
    torch.cuda.empty_cache()
    return out


SM_CASES = {"sm-e": _sm_trainer, "sm-f": _sm_unify, "sm-g": _sm_llm}


def _mt_one_rank(card: str) -> dict:
    """(a): the train phase's Trainer on one device, then on one NCCL rank
    through the sharded path (``make_mesh(model=1)`` in this process), each
    MT_STEPS Adam steps from the same parameters on the same batch."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from flexflow_tpu_torch.models import params as params_lib
    from flexflow_tpu_torch.parallel.mesh import make_mesh
    from flexflow_tpu_torch.specs import ModelSpec
    from flexflow_tpu_torch.training import AdamOptimizer, Trainer

    dev = torch.device("cuda")
    spec = ModelSpec(**{**LLAMA2_7B, "num_layers": TRAIN_LAYERS})
    params = params_lib.init_params(spec, torch.Generator(device=dev).manual_seed(0),
                                    torch.float32, dev)
    bx, by = _mt_batch(spec.vocab_size)
    tr = Trainer(spec, params, AdamOptimizer(lr=TRAIN_LR), device=dev)
    one, one_ms = _mt_trainer_run(tr, bx, by)
    del tr
    torch.cuda.empty_cache()
    mesh = make_mesh(model=1, device=dev)
    require(mesh.backend == "nccl", f"meshtrain (a): backend {mesh.backend}, not nccl")
    try:
        tr = Trainer(spec, params, AdamOptimizer(lr=TRAIN_LR), mesh=mesh)
        got, got_ms = _mt_trainer_run(tr, bx, by)
    finally:
        dist.destroy_process_group()
    del tr, params
    gc.collect()
    torch.cuda.empty_cache()
    ulps = [abs(a - b) / float(np.spacing(np.float32(b))) for a, b in zip(got, one)]  # f32 ulps
    rel = max(abs(a - b) / abs(b) for a, b in zip(got, one))
    require(rel <= MT_ONE_RANK_REL,
            f"meshtrain (a): one NCCL rank's losses {got} against one device's {one}")
    step, step1 = float(sum(got_ms[1:]) / (MT_STEPS - 1)), float(sum(one_ms[1:]) / (MT_STEPS - 1))
    same = ("bitwise" if got == one else
            f"{max(ulps):.0f} ulp at most, limit {MT_ONE_RANK_REL} relative")
    train_ms = _SERVED.get("train_step_ms")
    log(f"  meshtrain (a) one NCCL rank, {TRAIN_LAYERS} layers, {TRAIN_BATCH} x {TRAIN_LEN} "
        f"tokens, Adam: losses {got} against one device's {one} ({same}); step {step:.1f} ms "
        f"against one device's {step1:.1f} (steps after the first)"
        + ("" if train_ms is None else f" and the train phase's {train_ms:.1f}") + f" [{card}]")
    return dict(losses=got, one_device_losses=one, bitwise=got == one, max_ulps=max(ulps),
                step_ms=step, one_device_step_ms=step1, train_phase_step_ms=train_ms)


def _mt_one_device_lora(card: str) -> dict:
    """(d), (e)'s one-device side: the routed prefill's logits and first
    tokens, the served LoRA run's tok/s, and MT_FT_STEPS finetuning steps
    on slot MT_FT_SLOT from the same adapters (ticked on their own: a
    session reads no cache, so serving beside it changes nothing)."""
    import torch

    from flexflow_tpu_torch.peft.finetune import FinetuneSession
    from flexflow_tpu_torch.serving.request_manager import RequestManager

    dev = torch.device("cuda")
    spec, engine, cfg = _mt_lora_model(None, dev)
    prompts = _prompts(spec.vocab_size)
    logits, first = _prefill_logits(engine, spec, prompts, adapters=LORA_IDS)
    rm = RequestManager(engine, decode_horizon=16, pipelined=True)
    try:
        _, st = _served(rm, prompts, MT_LORA_NEW, spec.vocab_size,
                        f"meshtrain (d) LoRA one device, {MT_LORA_LAYERS} layers",
                        adapters=LORA_IDS)
    finally:
        rm.close()
    session = FinetuneSession(spec, cfg, MT_FT_SLOT,
                              _finetune_data(spec.vocab_size)[:MT_FT_STEPS], epochs=1)
    while not session.tick(engine):
        pass
    out = dict(logits=logits, first=first, decode_tok_s=st["decode_tok_s"],
               losses=session.losses, slot=_mt_slot(engine, spec))
    del engine, rm, session
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _mt_check(what: str, ranks: list, one: dict, card: str) -> dict:
    """Rank 0's (b) / (c) / (d) + (e) results of one spawned run (``what``:
    its backend) against one device (every rank's losses and tokens equal
    to rank 0's)."""
    r0, n = ranks[0], len(ranks)
    for r in ranks[1:]:
        for case in r0:
            for key in ("losses", "tokens", "first"):
                require(r[case].get(key) == r0[case].get(key),
                        f"meshtrain {what} ({case}): ranks disagree on {key}")
    out = {}
    for case, name, deg in (("mt-b", "b", f"T={n}"), ("mt-c", "c", f"D={n}")):
        st = r0[case]
        rel = max(abs(a - b) / abs(b) for a, b in zip(st["losses"], st["ref_losses"]))
        require(rel <= 1e-5, f"meshtrain ({name}) {what}: losses {st['losses']} against one "
                             f"device's {st['ref_losses']}")
        require(st["params_rel"] <= 1e-4,
                f"meshtrain ({name}) {what}: full_params {st['params_worst_leaf']} off by "
                f"{st['params_rel']} of its magnitude")
        step = sum(st["step_ms"][1:]) / (MT_STEPS - 1)
        share = sum(st["allreduce_ms"][1:]) / max(sum(st["step_ms"][1:]), 1e-9)
        out[name] = dict(losses=st["losses"], ref_losses=st["ref_losses"], loss_rel=rel,
                         params_rel=st["params_rel"], step_ms=step, allreduce_share=share,
                         allreduce_gb=st["allreduce_bytes"] / 1e9,
                         ref_step_ms=sum(st["ref_step_ms"][1:]) / (MT_STEPS - 1))
        log(f"  meshtrain ({name}) {deg} {what}, {MT_RANK_LAYERS} layer, {MT_STEPS} SGD steps: "
            f"losses within {rel:.3g} relative of one device's, full_params within "
            f"{st['params_rel']:.3g} of each leaf's magnitude; step {step:.1f} ms against one "
            f"device's {out[name]['ref_step_ms']:.1f}"
            + (f"; gradient all-reduce {share:.1%} of a step ({st['allreduce_bytes'] / 1e9:.2f} "
               "GB of f32 gradients)" if st["allreduce_ms"] else "") + f" [{card}]")
    d = r0["mt-d"]
    out["d"] = dict(_first_token_rule(f"meshtrain (d) LoRA T={n} {what}", d["logits"], one["logits"],
                                      d["first"], one["first"], limit=MT_LORA_LOGITS_REL),
                    decode_tok_s=d["decode_tok_s"], one_device_tok_s=one["decode_tok_s"],
                    launches=d["launches"], seconds=d["seconds"])
    log(f"  meshtrain (d) LoRA T={n} {what}: decode {d['decode_tok_s']:.1f} tok/s with (e)'s "
        f"finetuning beside it, against one device's {one['decode_tok_s']:.1f} without [{card}]")
    rel = max(abs(a - b) / abs(b) for a, b in zip(d["losses"], one["losses"]))
    require(len(d["losses"]) == MT_FT_STEPS and rel <= 1e-3,
            f"meshtrain (e) {what}: finetuning losses {d['losses']} against {one['losses']}")
    worst = 0.0
    for m, ab in one["slot"].items():
        for k, want in ab.items():
            worst = max(worst, ((d["slot"][m][k] - want).abs().max() / want.abs().max()).item())
    require(worst <= 1e-3, f"meshtrain (e) {what}: the gathered slot is {worst} off")
    out["e"] = dict(losses=d["losses"], one_device_losses=one["losses"], loss_rel=rel,
                    slot_rel=worst)
    log(f"  meshtrain (e) T={n} {what}: {MT_FT_STEPS} SGD steps on slot {MT_FT_SLOT} beside the "
        f"decode: losses {[round(v, 5) for v in d['losses']]} within {rel:.3g} relative of one "
        f"device's, the gathered slot within {worst:.3g} of each leaf's magnitude")
    return out


def _sm_one_device(card: str) -> dict:
    """search (f) and (g)'s one-device side: mlp_unify's CLI with
    ``SM_UNIFY_ARGS`` in this process (no group: one device, the joint plan
    at two devices, no measured search), and the (g) model served on one
    device with the same flags but the search's."""
    import contextlib
    import io

    import torch

    from flexflow_tpu_torch.examples import mlp_unify

    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        hist = mlp_unify.main(list(SM_UNIFY_ARGS))
    out = dict(unify_losses=[h["loss"] for h in hist], unify_s=time.perf_counter() - t0)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    llm = _sm_llm_class()(torch.device("cuda"))
    llm.compile(max_requests_per_batch=8, max_seq_length=1024, max_tokens_per_batch=1024)
    out["llm"] = _sm_serve(llm, "search (g) one device")
    out["llm_s"] = time.perf_counter() - t0
    llm.rm.close()
    del llm
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _sm_check(ranks: list, one: dict, card: str) -> dict:
    """search (e)-(g): every rank's report and choice equal; (e)'s report
    the rule's (the legal layouts of the world ranked by ``analytic_cost``,
    each measured) and its step bitwise a fresh explicit mesh's; (f)'s
    losses within 1e-5 of one device's; (g)'s first tokens one device's."""
    import numpy as np

    from flexflow_tpu_torch.parallel import auto as auto_lib
    from flexflow_tpu_torch.specs import ModelSpec

    r0, n = ranks[0], len(ranks)
    for r in ranks[1:]:
        for case, keys in (("sm-e", ("report", "chosen")), ("sm-f", ("report", "cut")),
                           ("sm-g", ("report", "degrees", "tokens"))):
            for k in keys:
                require(r[case][k] == r0[case][k], f"search {case[-1]}: the ranks disagree on {k}")
    out = {}
    e = r0["sm-e"]
    spec = ModelSpec(**{**LLAMA2_7B, "num_layers": MT_RANK_LAYERS})
    ranked = sorted(auto_lib.enumerate_layouts(n, spec, TRAIN_BATCH), key=lambda lo:
                    auto_lib.analytic_cost(lo, spec, TRAIN_BATCH, TRAIN_LEN))
    rule = [(str(lo), auto_lib.analytic_cost(lo, spec, TRAIN_BATCH, TRAIN_LEN)) for lo in ranked]
    require([(x["layout"], x["analytic_s"]) for x in e["report"]] == rule[:3],
            f"search (e): the report {e['report']} is not the rule's {rule}")
    require(all(0 < x["measured_s"] < float("inf") for x in e["report"]),
            f"search (e): a candidate did not run: {e['report']}")
    require(all(r["sm-e"]["loss"] == r["sm-e"]["fresh_loss"] and r["sm-e"]["params_bitwise"]
                for r in ranks),
            f"search (e): the step under the chosen layout {e['loss']} is not bitwise a fresh "
            f"Trainer(mesh=make_mesh{e['chosen']})'s {e['fresh_loss']}")
    out["e"] = dict(report=e["report"], chosen=e["chosen"], search_s=e["search_s"],
                    loss=e["loss"], seconds=e["seconds"])
    log(f"  search (e) Trainer(mesh='auto') over {n} gloo ranks, LLaMA-2-7B width, "
        f"{MT_RANK_LAYERS} layer, f32, {TRAIN_BATCH} x {TRAIN_LEN}: candidates "
        + "; ".join(f"{x['layout']}: analytic {x['analytic_s']:.4g} s, measured "
                    f"{x['measured_s']:.4g} s" for x in e["report"])
        + f" (equal on every rank); chose data={e['chosen'][0]} pipe={e['chosen'][1]} "
        f"model={e['chosen'][2]} in {e['search_s']:.1f} s; the next step's loss {e['loss']} "
        f"and parameters bitwise a fresh explicit-mesh Trainer's; case wall {e['seconds']:.1f} s "
        f"(gloo ranks on one card: no mesh speed) [{card}]")
    f = r0["sm-f"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(f["losses"], one["unify_losses"]))
    require(len(f["losses"]) == len(one["unify_losses"]) and rel <= 1e-5,
            f"search (f): losses {f['losses']} against one device's {one['unify_losses']}")
    require("final:" in f["text"] and "final:" not in ranks[1]["sm-f"]["text"],
            "search (f): mlp_unify printed on a rank other than 0, or not on rank 0")
    out["f"] = dict(report=f["report"], cut=f["cut"][:2], search_s=f["seconds"],
                    losses=f["losses"], loss_rel=rel, seconds=r0["sm-f"]["seconds"])
    log(f"  search (f) mlp_unify {' '.join(SM_UNIFY_ARGS)} over {n} gloo ranks: candidates "
        + "; ".join(f"{x['layout']}: " + (f"{x['measured_s']:.4g} s" if "measured_s" in x
                                          else x["error"]) for x in f["report"])
        + f"; chose data={f['cut'][0]} model={f['cut'][1]} (cut leaves {f['cut'][2]}) in "
        f"{f['seconds']:.1f} s; losses {f['losses']} within {rel:.3g} relative of one "
        f"device's; case wall {out['f']['seconds']:.1f} s [{card}]")
    g = r0["sm-g"]
    want = one["llm"]["tokens"]
    firsts = sum(a[0] == b[0] for a, b in zip(g["tokens"], want))
    equal = sum(x == y for a, b in zip(g["tokens"], want) for x, y in zip(a, b))
    total = sum(len(b) for b in want)
    require(firsts == len(want), f"search (g): {firsts} of {len(want)} first tokens equal one "
                                 "device's")
    for k in ("decode_attention", "flash_prefill"):
        require(g["launches"][k] > 0, f"search (g): {k} was never launched")
    out["g"] = dict(report=g["report"], degrees=g["degrees"], compile_s=g["compile_s"],
                    first_equal=firsts, tokens_equal=equal, tokens=total, tok_s=g["tok_s"],
                    one_device_tok_s=one["llm"]["tok_s"], seconds=g["seconds"],
                    launches={k: sum(r["sm-g"]["launches"][k] for r in ranks)
                              for k in g["launches"]})
    log(f"  search (g) LLM.compile(auto_parallel=True) over {n} gloo ranks, LLaMA-2-7B width, "
        f"{SM_LLM_LAYERS} layers, bf16: candidates "
        + "; ".join(f"{x['layout']}: analytic {x['analytic_s']:.4g} s, measured "
                    f"{x['measured_s']:.4g} s" for x in g["report"])
        + f"; served at data={g['degrees'][0]} pipe={g['degrees'][1]} model={g['degrees'][2]} "
        f"(compile with the search {g['compile_s']:.1f} s); {firsts} of {len(want)} first "
        f"tokens and {equal} of {total} tokens equal one device's (bf16: near-ties flip at a "
        f"cut); {g['tok_s']:.1f} tok/s against one device's {one['llm']['tok_s']:.1f} (gloo "
        f"ranks on one card: no mesh speed); case wall {g['seconds']:.1f} s [{card}]")
    return out


def meshtrain_phase(card: str) -> dict:
    """Gradients and adapters over a mesh (see the module docstring, phase
    meshtrain): (a) one NCCL rank in this process; the one-device side of
    (d) and (e); two ranks sharing the card over gloo for (b)-(e),
    spawned; (f) NCCL across GPUs when the machine has more than one."""
    import torch

    t_phase = time.perf_counter()
    out: dict = {"card": card, "a": _mt_one_rank(card)}
    one = _mt_one_device_lora(card)
    sm_one = _sm_one_device(card)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mt_")
    t0 = time.perf_counter()
    try:
        ranks = _spawn_tp(2, "gloo", tmp, ("mt-b", "mt-c", "mt-d", *SM_CASES), 900)
        out["ranks_s"] = time.perf_counter() - t0
        out.update(_mt_check("over gloo", ranks, one, card))
        out["search"] = _sm_check(ranks, sm_one, card)
        n = torch.cuda.device_count()
        if n > 1:
            out["f"] = _mt_check("over NCCL",
                                 _spawn_tp(min(4, n), "nccl", tmp, ("mt-b", "mt-c", "mt-d"), 600),
                                 one, card)
        else:
            log(f"  meshtrain (f) did not run: the machine shows {n} GPU (NCCL takes one device "
                "a rank)")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"  meshtrain phase wall {out['seconds']:.1f} s, the spawned ranks' {out['ranks_s']:.1f} "
        f"s of it [{card}]")
    return out


# ---------------------------------------------------------------------------
# the serving layouts left under a mesh (the layouts phase)
# ---------------------------------------------------------------------------

LAYOUT_LAYERS = 2  # (b): LLaMA-2-7B INT8 and INT4 under hybrid_ffn, full width (cut from 4)
# (a)'s two gloo ranks: LLaMA-2-7B INT8 at T = 2, resident and offload; the
# one NCCL rank serves all 32 layers
LAYOUT_OFFLOAD_LAYERS = 8
LAYOUT_NEW_TOKENS = 16  # (a)'s gloo runs and (b): new tokens a request (cut from 32 for time)
# (b) runs f32 activations and an f32 KV cache over the INT8 / INT4 carriers
# (the kernels take f32): at bf16 the hybrid ranks round each layer's FFN
# output from two f32 partials where one device rounds one call's, and two
# of the eight first tokens parted at rows whose top-2 margin lay within
# twice the logits' difference (which any flip must), as in meshtrain (d)
LAYOUT_HYBRID_DTYPE = "float32"
LAYOUT_EP_STEPS = 8  # (c): greedy decode steps after the prefill
# (c) runs Mixtral twice, in bf16 (the served dtype) and in f32 (weights,
# activations and KV cache). The bf16 run records every layer's router
# logits over the prefill's tokens on both sides and counts the tokens
# whose top-k experts differ from one device's: a request's logits are
# held to TP_LOGITS_REL only while its routing agrees everywhere, and up
# to its first differing layer its router logits must agree to
# TP_LOGITS_REL of their magnitude. The f32 run holds every request.
LAYOUT_EP_DTYPES = ("bfloat16", "float32")
# (b) and (c)'s f32 runs: the T-rank prefill logits against one device's,
# max |difference| over the largest |logit|; calls 4 and 5 of the slice that
# added the phase measured 2.0e-6 to 3.1e-6
LAYOUT_F32_REL = 1e-4


def _copy_alone_s(store) -> float:
    """Every layer of an offload engine's ``LayerStore`` copied once into its
    slots, no compute (the stream alone), synchronised; the ring restarted
    after."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for layer in range(store.num_layers):
        store._copy(layer % 2, layer)
    torch.cuda.synchronize()
    out = time.perf_counter() - t0
    store.restart(0)
    return out


def _la_offload_pair(spec, mesh, dev, max_new: int, what: str, hybrid_ffn: bool = False,
                     bits: int = 8, dtype: str = "bfloat16") -> dict:
    """One host build of ``spec`` (this rank's cut under ``mesh``, pinned,
    ``build_params(host_layers=True, mesh=)``), served resident then
    offload: each run's tokens and stats, the pinned GiB, the copy-alone
    time and the offload run's decode step wall (8 requests decode
    together: 8 / tok/s)."""
    import torch

    from flexflow_tpu_torch.models import layer_store as offload_lib
    from flexflow_tpu_torch.models import params as params_lib
    from flexflow_tpu_torch.serving.engine import InferenceEngine
    from flexflow_tpu_torch.serving.request_manager import RequestManager

    pinned0, t0 = offload_lib.pinned_bytes, time.perf_counter()
    dt = getattr(torch, dtype)
    if hybrid_ffn:  # the hybrid cut: (b)'s draw, each layer cut as it is quantized
        params = _la_hybrid_model(spec, mesh, dev, bits, dtype, host_layers=True)
    else:
        params = params_lib.init_quantized_params(
            spec, torch.Generator(device=dev).manual_seed(0), bits=bits, group_size=128,
            dtype=dt, device=dev, host_layers=True, mesh=mesh)
    torch.cuda.synchronize()
    out = {"init_s": time.perf_counter() - t0,
           "pinned_gib": (offload_lib.pinned_bytes - pinned0) / 2**30}
    prompts = _prompts(spec.vocab_size)
    for offload in (False, True):
        name = "offload" if offload else "resident"
        engine = InferenceEngine(spec, params, max_requests_per_batch=8, max_seq_len=1024,
                                 max_tokens_per_batch=0, cache_dtype=dt, device=dev,
                                 offload=offload, mesh=mesh, hybrid_ffn=hybrid_ffn)
        rm = RequestManager(engine, decode_horizon=16, pipelined=True)
        try:
            reqs, st = _served(rm, prompts, max_new, spec.vocab_size, f"{what} {name}",
                               replayed=engine.graphs is not None)
        finally:
            rm.close()
        st["tokens"] = [r.output_tokens for r in reqs]
        if offload:
            store = engine.params["layers"]
            require(store.layer_bytes * spec.num_layers
                    == offload_lib.pinned_bytes - pinned0,
                    f"{what}: the rank pins more than its cut of the layers once")
            out["copy_alone_s"] = _copy_alone_s(store)
            out["step_wall_s"] = len(prompts) / st["decode_tok_s"]
            out["logits"], out["first"] = _prefill_logits(engine, spec, prompts)
            out["kv_gib"] = _tree_gib(engine.cache._asdict())
            del store
        out[name] = st
        del engine, rm
        gc.collect()
        torch.cuda.empty_cache()
    del params
    gc.collect()
    require(out["offload"]["tokens"] == out["resident"]["tokens"],
            f"{what}: offload tokens differ from the resident run's")
    # a cache cut on seq decodes through K5's shard form and the merge
    cut = mesh is not None and mesh.seq > 1
    for k in (("decode_attention_shard", "merge_states") if cut else ("decode_attention",)) + (
            "flash_prefill",):
        require(out["offload"]["launches"][k] > 0, f"{what}: {k} was never launched")
    return out


def _la_case_a(mesh, dev, refs) -> dict:
    """(a) over the spawned ranks: LLaMA-2-7B INT8 at LAYOUT_OFFLOAD_LAYERS
    layers, T ranks, resident then offload over one pinned build of the
    rank's cut."""
    from flexflow_tpu_torch.specs import ModelSpec

    spec = ModelSpec(**{**LLAMA2_7B, "num_layers": LAYOUT_OFFLOAD_LAYERS})
    return _la_offload_pair(spec, mesh, dev, LAYOUT_NEW_TOKENS,
                            f"layouts (a) offload T={mesh.model}")


def _la_hybrid_model(spec, mesh, dev, bits: int, dtype: str, host_layers: bool = False):
    """LLaMA-2-7B at ``spec``'s depth from seed 0 (a ``dtype`` draw), each
    layer's slab quantized whole at ``bits`` and cut (the hybrid FFN cut
    under ``mesh``; the whole model without), in host memory with
    ``host_layers``."""
    import torch

    from flexflow_tpu_torch.models import params as params_lib

    dt = getattr(torch, dtype)
    whole = params_lib.init_params(spec, torch.Generator(device=dev).manual_seed(0), dt, dev)
    layers = whole.pop("layers")
    return params_lib.build_params(spec, whole, lambda i: ((n, v[i]) for n, v in layers.items()),
                                   dtype=dt, device=dev, bits=bits, group_size=128,
                                   host_layers=host_layers, mesh=mesh,
                                   hybrid_ffn=mesh is not None)


def _la_case_b(mesh, dev, refs) -> dict:
    """(b): ``hybrid_ffn`` over the data ranks, LLaMA-2-7B INT8 and INT4 at
    LAYOUT_LAYERS layers in LAYOUT_HYBRID_DTYPE (prefill logits, first
    tokens, the served run), then INT8 with offload once."""
    import torch

    from flexflow_tpu_torch.serving.engine import InferenceEngine
    from flexflow_tpu_torch.serving.request_manager import RequestManager
    from flexflow_tpu_torch.specs import ModelSpec

    spec = ModelSpec(**{**LLAMA2_7B, "num_layers": LAYOUT_LAYERS})
    prompts = _prompts(spec.vocab_size)
    out = {}
    for bits in (8, 4):
        params = _la_hybrid_model(spec, mesh, dev, bits, LAYOUT_HYBRID_DTYPE)
        engine = InferenceEngine(spec, params, max_requests_per_batch=8, max_seq_len=1024,
                                 max_tokens_per_batch=0,
                                 cache_dtype=getattr(torch, LAYOUT_HYBRID_DTYPE), device=dev,
                                 mesh=mesh, hybrid_ffn=True)
        del params
        require(engine.slots.n == 8 and engine.shard.ffn is not None,
                f"layouts (b) INT{bits}: a hybrid rank holds every slot and its FFN cut")
        rm = RequestManager(engine, decode_horizon=16, pipelined=True)
        try:
            reqs, st = _served(rm, prompts, LAYOUT_NEW_TOKENS, spec.vocab_size,
                               f"layouts (b) hybrid INT{bits} D={mesh.data}",
                               replayed=engine.graphs is not None)
            st["tokens"] = [r.output_tokens for r in reqs]
            st["logits"], st["first"] = _prefill_logits(engine, spec, prompts)
        finally:
            rm.close()
        out[f"int{bits}"] = st
        del engine, rm
        gc.collect()
        torch.cuda.empty_cache()
    out["offload"] = _la_offload_pair(spec, mesh, dev, LAYOUT_NEW_TOKENS,
                                      f"layouts (b) hybrid INT8 D={mesh.data} offload",
                                      hybrid_ffn=True, dtype=LAYOUT_HYBRID_DTYPE)
    return out


def _la_ep_logits(spec, params, shard, prompts, steps: int, dev, dtype: str):
    """A batched flash prefill of ``prompts`` (K/V into a fresh cache) and
    ``steps`` greedy decode steps through ``forward_cached`` on ``params``
    (this rank's cut under ``shard``), the launch counts set to 0 before
    and read after. Returns (f32 logits [steps + 1, n, V] on the host,
    launches, the prefill's router logits [L, n, bucket, E] on the host)."""
    import numpy as np
    import torch

    from flexflow_tpu_torch.models import decoder
    from flexflow_tpu_torch.models.decoder import to_device
    from flexflow_tpu_torch.ops import moe as moe_lib

    n = len(prompts)
    bucket = 1024
    cache = decoder.init_kv_cache(spec, n, bucket + steps, getattr(torch, dtype), dev,
                                  num_kv_heads=None if shard is None else shard.num_kv_cache(spec))
    toks = np.zeros((n, bucket), np.int32)
    lens = np.array([len(p) for p in prompts], np.int32)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    tk, ln = to_device(toks, dev), to_device(lens, dev)
    pos = torch.arange(bucket, dtype=torch.int32, device=dev)[None].expand(n, bucket)

    def sink(layer, k, v):
        decoder.commit_kv_windows(cache.k[layer:layer + 1], cache.v[layer:layer + 1],
                                  k.permute(0, 2, 1, 3)[None].to(cache.k.dtype),
                                  v.permute(0, 2, 1, 3)[None].to(cache.v.dtype),
                                  np.zeros(n, np.int64), list(range(n)))

    routes, router_logits = [], moe_lib.router_logits

    def recorded(x, router):  # each layer's router logits, one call a layer
        out = router_logits(x, router)
        routes.append(out.reshape(n, bucket, -1).cpu())
        return out

    torch.cuda.synchronize()
    _launches(reset=True)
    out = []
    with torch.no_grad():
        moe_lib.router_logits = recorded
        try:
            lg, _ = decoder.forward(spec, params, tk, pos, lengths=ln, flash=True, kv_sink=sink,
                                    logits_at=ln - 1, shard=shard)
        finally:
            moe_lib.router_logits = router_logits
        out.append(lg)
        cur, cl = lg.argmax(-1).to(torch.int32), ln.clone()
        for _ in range(steps):
            lg, _ = decoder.forward_cached(spec, params, cur[:, None], cache, cl, shard=shard)
            out.append(lg[:, 0])
            cur, cl = lg[:, 0].argmax(-1).to(torch.int32), cl + 1
    torch.cuda.synchronize()
    return torch.stack(out).float().cpu(), _launches(), torch.stack(routes)


def _la_case_c(mesh, dev, refs) -> dict:
    """(c): ``expert_parallel`` at T ranks, Mixtral-8x7B at
    TP_MIXTRAL_LAYERS layers in each of LAYOUT_EP_DTYPES (the whole draw
    cut at once, ``shard_params(expert_parallel=True)``), through
    ``decoder.forward`` and ``forward_cached`` as JAX reaches EP."""
    import torch

    from flexflow_tpu_torch.models import params as params_lib
    from flexflow_tpu_torch.parallel.sharding import shard_params, tree_shard

    spec = mixtral_spec(TP_MIXTRAL_LAYERS)
    out = {}
    for dtype in LAYOUT_EP_DTYPES:
        whole = params_lib.init_params(spec, torch.Generator(device=dev).manual_seed(0),
                                       getattr(torch, dtype), dev)
        params = shard_params(spec, whole, mesh, expert_parallel=True)
        shard = tree_shard(spec, params, mesh, expert_parallel=True)
        del whole
        gc.collect()
        torch.cuda.empty_cache()
        require(shard.expert_ids() is not None
                and params["layers"]["wg"].shape[1] == spec.moe.num_experts // mesh.model,
                f"layouts (c): rank {mesh.rank} holds {params['layers']['wg'].shape[1]} experts")
        rank_gib = sum(t.nbytes for _, t in _param_leaves(params)) / 2**30
        t0 = time.perf_counter()
        logits, launches, routes = _la_ep_logits(spec, params, shard, _prompts(spec.vocab_size),
                                                 LAYOUT_EP_STEPS, dev, dtype)
        out[dtype] = dict(logits=logits, launches=launches, routes=routes,
                          experts=shard.expert_ids(), rank_gib=rank_gib,
                          run_s=time.perf_counter() - t0)
        del params
        gc.collect()
        torch.cuda.empty_cache()
    return out


LA_CASES = {"la-a": _la_case_a, "la-b": _la_case_b, "la-c": _la_case_c}


def _la_nccl_rank(card: str, dev) -> dict:
    """(a) on one NCCL rank in this process: LLaMA-2-7B INT8 at
    LAYOUT_OFFLOAD_LAYERS layers, the serve prompts x LAYOUT_NEW_TOKENS,
    resident then offload over one pinned build through the sharded path
    (the offload phase serves all 32 layers on one device)."""
    import torch.distributed as dist

    from flexflow_tpu_torch.parallel.mesh import make_mesh
    from flexflow_tpu_torch.specs import ModelSpec

    mesh = make_mesh(model=1, device=dev)
    require(mesh.backend == "nccl", f"layouts (a): backend {mesh.backend}, not nccl")
    try:
        spec = ModelSpec(**{**LLAMA2_7B, "num_layers": LAYOUT_OFFLOAD_LAYERS})
        out = _la_offload_pair(spec, mesh, dev, LAYOUT_NEW_TOKENS,
                               "layouts (a) offload, one NCCL rank")
    finally:
        dist.destroy_process_group()
    for name in ("resident", "offload"):
        _log_served(f"layouts (a) LLaMA-2-7B INT8 {LAYOUT_OFFLOAD_LAYERS} layers one NCCL rank, "
                    f"{name}", out[name], card)
    log(f"  layouts (a) one NCCL rank: every token of the offload run equal to the resident "
        f"run's (8 x {LAYOUT_NEW_TOKENS}); {out['pinned_gib']:.2f} GiB pinned, built in {out['init_s']:.1f} s; "
        f"copy alone {out['copy_alone_s']:.3f} s, an offload decode step "
        f"{out['step_wall_s']:.3f} s; decode {out['offload']['decode_tok_s']:.1f} tok/s offload "
        f"against {out['resident']['decode_tok_s']:.1f} resident [{card}]")
    out.pop("logits"), out.pop("first")
    return out


def _la_one_device_refs(dev) -> dict:
    """The one-device side of (b) and (c): LLaMA-2-7B INT8 and INT4 at
    LAYOUT_LAYERS layers in LAYOUT_HYBRID_DTYPE (prefill logits, first
    tokens) and Mixtral-8x7B in each of LAYOUT_EP_DTYPES at
    TP_MIXTRAL_LAYERS layers (the prefill's router logits, the prefill and
    decode steps)."""
    import torch

    from flexflow_tpu_torch.models import params as params_lib
    from flexflow_tpu_torch.serving.engine import InferenceEngine
    from flexflow_tpu_torch.specs import ModelSpec

    spec = ModelSpec(**{**LLAMA2_7B, "num_layers": LAYOUT_LAYERS})
    prompts = _prompts(spec.vocab_size)
    refs = {}
    for bits in (8, 4):
        engine = InferenceEngine(spec, _la_hybrid_model(spec, None, dev, bits,
                                                        LAYOUT_HYBRID_DTYPE),
                                 max_requests_per_batch=8, max_seq_len=1024,
                                 max_tokens_per_batch=0,
                                 cache_dtype=getattr(torch, LAYOUT_HYBRID_DTYPE), device=dev)
        refs[f"int{bits}"] = _prefill_logits(engine, spec, prompts)
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    mspec = mixtral_spec(TP_MIXTRAL_LAYERS)
    for dtype in LAYOUT_EP_DTYPES:
        mparams = params_lib.init_params(mspec, torch.Generator(device=dev).manual_seed(0),
                                         getattr(torch, dtype), dev)
        logits, _, routes = _la_ep_logits(mspec, mparams, None, _prompts(mspec.vocab_size),
                                          LAYOUT_EP_STEPS, dev, dtype)
        refs[f"mixtral-{dtype}"] = (logits, routes)
        del mparams
        gc.collect()
        torch.cuda.empty_cache()
    return refs


def _la_routing_rule(what: str, got, want, got_routes, want_routes) -> dict:
    """(c)'s bf16 check. ``*_routes``: the prefill's router logits [L, n,
    bucket, E] of the T ranks and of one device. Per request and layer it
    counts the prompt tokens whose top-k experts differ from one device's.
    Up to a request's first such layer its router logits must agree to
    ``TP_LOGITS_REL`` of their magnitude (the hidden states then differ by
    rounding alone); a request routed as on one device at every layer is
    held to ``_first_token_rule``. A differing token's top-k margin on one
    device lies within twice the router logits' difference, as any flip's
    must; the margins and differences are reported."""
    from flexflow_tpu_torch.ops.moe import route_topk

    top_k = mixtral_spec(1).moe.top_k
    n_layers = want_routes.shape[0]
    flips = [0] * n_layers  # prompt tokens routed otherwise than on one device, a layer
    first = [None] * len(PROMPT_LENS)  # each request's first layer with such a token
    at_first = []  # each first such layer: its tokens, their margins, the router error
    pre = 0.0  # the largest router error / magnitude before any routing differs
    for i, t in enumerate(PROMPT_LENS):
        for layer in range(n_layers):
            g, w = got_routes[layer, i, :t].float(), want_routes[layer, i, :t].float()
            apart = (route_topk(g, top_k)[1].sort(-1).values
                     != route_topk(w, top_k)[1].sort(-1).values).any(-1)
            flips[layer] += int(apart.sum())
            if first[i] is not None:
                continue
            err, scale = (g - w).abs().max().item(), w.abs().max().item()
            require(err <= TP_LOGITS_REL * scale,
                    f"{what}: request {i} layer {layer}: router logits max|diff| {err} > "
                    f"{TP_LOGITS_REL} x {scale} before any routing differs")
            pre = max(pre, err / scale)
            if apart.any():
                first[i] = layer
                top = w[apart].sort(-1, descending=True).values
                at_first.append(dict(request=i, layer=layer, tokens=int(apart.sum()),
                                     margins=(top[:, top_k - 1] - top[:, top_k]).tolist(),
                                     router_err=err))
    clean = [i for i in range(len(PROMPT_LENS)) if first[i] is None]
    res = dict(flips_per_layer=flips, tokens=sum(PROMPT_LENS), first_flip_layer=first,
               at_first=at_first, router_rel_before=pre, clean_requests=clean)
    log(f"  {what}: prompt tokens routed otherwise than on one device, by layer {flips} of "
        f"{sum(PROMPT_LENS)}; each request's first such layer {first}; before it the router "
        f"logits within {pre:.3g} of their magnitude (limit {TP_LOGITS_REL}); at it "
        + "; ".join(f"request {a['request']} layer {a['layer']}: {a['tokens']} token(s), "
                    f"top-{top_k} margins {[round(m, 5) for m in a['margins'][:4]]} against "
                    f"a router max|diff| {a['router_err']:.4g}" for a in at_first))
    if clean:
        res.update(_first_token_rule(f"{what}, the {len(clean)} requests routed as on one "
                                     f"device", got[0][clean], want[0][clean],
                                     got[0][clean].argmax(-1).tolist(),
                                     want[0][clean].argmax(-1).tolist()))
    else:
        log(f"  {what}: every request has a token routed otherwise, so no request's logits "
            "are held to one device's")
    return res


def _la_check(what: str, ranks: list, refs: dict, card: str) -> dict:
    """Rank 0's (a)-(c) of one spawned run against each other and one
    device (every rank's tokens equal to rank 0's)."""
    r0, n = ranks[0], len(ranks)
    for r in ranks[1:]:
        for run in (("la-a", "resident"), ("la-a", "offload"), ("la-b", "int8"),
                    ("la-b", "int4")):
            require(r[run[0]][run[1]]["tokens"] == r0[run[0]][run[1]]["tokens"],
                    f"layouts {what} {run}: ranks disagree on the tokens")
    out = {}
    a = r0["la-a"]
    out["a"] = dict(pinned_gib=[r["la-a"]["pinned_gib"] for r in ranks],
                    copy_alone_s=[r["la-a"]["copy_alone_s"] for r in ranks],
                    step_wall_s=a["step_wall_s"], resident=a["resident"], offload=a["offload"],
                    seconds=a["seconds"])
    log(f"  layouts (a) T={n} {what}, LLaMA-2-7B INT8 {LAYOUT_OFFLOAD_LAYERS} layers: every "
        f"token of the offload run equal to the resident run's (8 x {LAYOUT_NEW_TOKENS}); pinned "
        f"GiB per rank {[round(g, 3) for g in out['a']['pinned_gib']]}, copy alone "
        f"{[round(c, 3) for c in out['a']['copy_alone_s']]} s, an offload decode step "
        f"{a['step_wall_s']:.3f} s; decode {a['offload']['decode_tok_s']:.1f} tok/s offload "
        f"against {a['resident']['decode_tok_s']:.1f} resident [{card}]")
    b = r0["la-b"]
    out["b"] = {}
    for bits in (8, 4):
        st = b[f"int{bits}"]
        want_logits, want_first = refs[f"int{bits}"]
        out["b"][f"int{bits}"] = dict(
            _first_token_rule(f"layouts (b) hybrid INT{bits} D={n} {what}", st["logits"],
                              want_logits, st["first"], want_first, LAYOUT_F32_REL),
            decode_tok_s=st["decode_tok_s"], launches=st["launches"])
    off = b["offload"]
    out["b"]["offload"] = dict(
        _first_token_rule(f"layouts (b) hybrid INT8 D={n} offload {what}", off["logits"],
                          refs["int8"][0], off["first"], refs["int8"][1], LAYOUT_F32_REL),
        pinned_gib=off["pinned_gib"], copy_alone_s=off["copy_alone_s"],
        step_wall_s=off["step_wall_s"], launches=off["offload"]["launches"],
        resident_launches=off["resident"]["launches"])
    log(f"  layouts (b) hybrid D={n} {what}: INT8 decode {b['int8']['decode_tok_s']:.1f} tok/s, "
        f"INT4 {b['int4']['decode_tok_s']:.1f}; with offload every token equal to the resident "
        f"hybrid run's, {off['pinned_gib']:.3f} GiB pinned a rank, copy alone "
        f"{off['copy_alone_s']:.3f} s, a decode step {off['step_wall_s']:.3f} s; "
        f"{b['seconds']:.1f} s [{card}]")
    c = r0["la-c"]
    out["c"] = {"launches": {k: sum(c[dt]["launches"][k] for dt in LAYOUT_EP_DTYPES)
                             for k in c[LAYOUT_EP_DTYPES[0]]["launches"]},
                "experts": [r["la-c"][LAYOUT_EP_DTYPES[0]]["experts"] for r in ranks]}
    for dtype in LAYOUT_EP_DTYPES:
        cd, (want, want_routes) = c[dtype], refs[f"mixtral-{dtype}"]
        got = cd["logits"]
        label = f"layouts (c) EP T={n} {what}, Mixtral-8x7B {dtype} {TP_MIXTRAL_LAYERS} layers"
        require(bool(got.isfinite().all()) and got.shape == want.shape,
                f"{label}: logits not finite or shaped {tuple(got.shape)}")
        steps_same = [next((j for j in range(got.shape[0])
                            if got[j, i].argmax() != want[j, i].argmax()), got.shape[0])
                      for i in range(got.shape[1])]
        if dtype == "float32":
            res = _first_token_rule(label, got[0], want[0], got[0].argmax(-1).tolist(),
                                    want[0].argmax(-1).tolist(), LAYOUT_F32_REL)
            require(all(k == got.shape[0] for k in steps_same),
                    f"{label}: greedy tokens part from one device's after {steps_same} positions")
        else:
            res = _la_routing_rule(label, got, want, cd["routes"], want_routes)
        worst = ((got - want).abs().amax(dim=(1, 2)) / want.abs().amax(dim=(1, 2))).tolist()
        rows = ((got[0] - want[0]).abs().amax(-1) / want[0].abs().amax()).tolist()
        res.update(rank_gib=[r["la-c"][dtype]["rank_gib"] for r in ranks],
                   greedy_equal_steps=steps_same, step_rel=worst, prefill_row_rel=rows,
                   run_s=cd["run_s"])
        out["c"][dtype] = res
        log(f"  {label}: {[round(g, 2) for g in res['rank_gib']]} GiB a rank; greedy tokens "
            f"equal to one device's for the first {steps_same} of {got.shape[0]} positions per "
            f"request; each step's max|diff| / max|logit| {[f'{w:.3g}' for w in worst]}, the "
            f"prefill's by request {[f'{r:.3g}' for r in rows]}; prefill + {LAYOUT_EP_STEPS} "
            f"steps {cd['run_s']:.2f} s [{card}]")
    log(f"  layouts (c) EP T={n} {what}: experts a rank {out['c']['experts']}")
    return out


def layouts_phase(card: str) -> dict:
    """The serving layouts left under a mesh (see the module docstring,
    phase layouts): (a) offload on one NCCL rank in this process; the
    one-device side of (b) and (c); two ranks sharing the card over gloo for
    (a)-(c), spawned; (d) NCCL across GPUs when the machine has more than
    one."""
    import torch

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    out: dict = {"card": card, "a_nccl": _la_nccl_rank(card, dev)}
    refs = _la_one_device_refs(dev)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_la_")
    t0 = time.perf_counter()
    try:
        ranks = _spawn_tp(2, "gloo", tmp, tuple(LA_CASES), 600)
        out["ranks_s"] = time.perf_counter() - t0
        out.update(_la_check("over gloo", ranks, refs, card))
        n = torch.cuda.device_count()
        if n > 1:
            out["d"] = _la_check("over NCCL", _spawn_tp(min(4, n), "nccl", tmp, tuple(LA_CASES),
                                                        600), refs, card)
        else:
            log(f"  layouts (d) did not run: the machine shows {n} GPU (NCCL takes one device a "
                "rank)")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"  layouts phase wall {out['seconds']:.1f} s, the spawned ranks' {out['ranks_s']:.1f} s "
        f"of it [{card}]")
    return out



# ---------------------------------------------------------------------------
# pipeline-parallel serving (the pp phase)
# ---------------------------------------------------------------------------

PP_MICROBATCHES = 2  # (a): M = P, the overlapped horizon
PP_INT4_LAYERS = 8  # (b): LLaMA-2-7B INT4 cut to 8 layers (time), full width
PP_INT4_MICROBATCHES = 4  # (b): M = 2P, tokens banked in the return hop
PP_CHUNK = 128  # (b): max_tokens_per_batch (the 600-, 400- and 256-token prompts in chunks)
PP_SPEC_MICROBATCHES = 2  # (d): M = P, the spec phase's pair at full width and depth
PP_SPEC_NEW = 16  # (d): new tokens a request (cut from the spec traffic's 64 for the run's time)


def _tree_gib(tree) -> float:
    """The bytes of a parameter tree's tensors and carriers, in GiB."""
    import torch

    from flexflow_tpu_torch.quant.weight_only import QuantizedArray

    if isinstance(tree, dict):
        return sum(_tree_gib(v) for v in tree.values())
    if isinstance(tree, QuantizedArray):
        return sum(_tree_gib(t) for t in (tree.q, tree.scale, tree.offset) if t is not None)
    return tree.numel() * tree.element_size() / 2**30 if isinstance(tree, torch.Tensor) else 0.0


def _pp_llama(mesh, dev, bits: int, layers: int, **engine_kw):
    """LLaMA-2-7B (``layers`` layers) quantized at ``bits`` on this rank's
    pipeline stage: the serve phase's draw (``_quant_params``: whole bf16
    leaves from seed 0), each layer's slab quantized whole and kept only on
    its stage (``build_params(mesh=)``), the lm_head quantized whole on the
    last stage; served through ``PipelineInferenceEngine`` (horizon 16,
    pipelined)."""
    import torch

    from flexflow_tpu_torch.models import params as params_lib
    from flexflow_tpu_torch.serving.pp_engine import PipelineInferenceEngine
    from flexflow_tpu_torch.serving.request_manager import RequestManager
    from flexflow_tpu_torch.specs import ModelSpec

    spec = ModelSpec(**{**LLAMA2_7B, "num_layers": layers})
    whole = params_lib.init_params(spec, torch.Generator(device=dev).manual_seed(0),
                                   torch.bfloat16, dev)
    stack = whole.pop("layers")
    params = params_lib.build_params(spec, whole, lambda i: ((n, v[i]) for n, v in stack.items()),
                                     dtype=torch.bfloat16, device=dev, bits=bits,
                                     group_size=128, mesh=mesh)
    del whole, stack
    torch.cuda.empty_cache()
    engine = PipelineInferenceEngine(spec, params, mesh=mesh, max_requests_per_batch=8,
                                     max_seq_len=1024, cache_dtype=torch.bfloat16, device=dev,
                                     **engine_kw)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return spec, engine, RequestManager(engine, decode_horizon=16, pipelined=True)


def _pp_serve(mesh, dev, what: str, bits: int, layers: int, **engine_kw) -> dict:
    """One pipelined run of the 8 prompts x 64 tokens on this rank's stage:
    the tokens, the run's stats and launches, the rank's hops and what it
    holds."""
    import torch

    t0 = time.perf_counter()
    spec, engine, rm = _pp_llama(mesh, dev, bits, layers, **engine_kw)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    held = dict(layer_gib=_tree_gib(engine.params["layers"]),
                top_gib=_tree_gib({k: v for k, v in engine.params.items() if k != "layers"}),
                kv_gib=_tree_gib(engine.cache._asdict()), top=sorted(
                    k for k in engine.params if k != "layers"),
                layers=engine.layers, allocated_gib=torch.cuda.memory_allocated() / 2**30)
    hops0, bytes0 = mesh.hops, mesh.hop_bytes
    try:
        reqs, st = _served(rm, _prompts(spec.vocab_size), 64, spec.vocab_size, what,
                           replayed=False)
    finally:
        rm.close()
    st.update(held, tokens=[r.output_tokens for r in reqs], build_s=build_s,
              hops=mesh.hops - hops0, hop_bytes=mesh.hop_bytes - bytes0)
    return st


def _pp_case_a(mesh, dev, refs) -> dict:
    """(a): LLaMA-2-7B INT8, 32 layers, M = P (the overlapped horizon)."""
    return _pp_serve(mesh, dev, f"pp (a) P={mesh.pipe}", 8, LLAMA2_7B["num_layers"],
                     num_microbatches=PP_MICROBATCHES)


def _pp_case_b(mesh, dev, refs) -> dict:
    """(b): INT4 at PP_INT4_LAYERS layers, chunked prefill, M = 2P."""
    return _pp_serve(mesh, dev, f"pp (b) INT4 P={mesh.pipe}", 4, PP_INT4_LAYERS,
                     num_microbatches=PP_INT4_MICROBATCHES, max_tokens_per_batch=PP_CHUNK)


def _pp_case_d(mesh, dev, refs) -> dict:
    """(d): the spec phase's pair through ``PipelineSpecEngine``: this rank's
    stage of the INT4 verifier (built whole, as the spec phase builds it,
    and cut at once: the whole tree freed) and the draft whole; the spec
    phase's managers and traffic."""
    import torch

    from flexflow_tpu_torch.parallel.sharding import shard_params
    from flexflow_tpu_torch.serving.pp_spec import PipelineSpecEngine

    t0 = time.perf_counter()
    dspec, vspec, dparams, vparams = _spec_pair(dev)
    vparams = shard_params(vspec, vparams, mesh)
    gc.collect()
    torch.cuda.empty_cache()
    engine = PipelineSpecEngine(vspec, vparams, dspec, dparams, mesh=mesh, beam_width=3,
                                beam_depth=4, max_requests_per_batch=8, max_seq_len=1024,
                                cache_dtype=torch.bfloat16,
                                num_microbatches=PP_SPEC_MICROBATCHES, device=dev)
    del vparams, dparams
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    held = dict(layer_gib=_tree_gib(engine.llm_params["layers"]),
                top_gib=_tree_gib({k: v for k, v in engine.llm_params.items() if k != "layers"}),
                kv_gib=_tree_gib(engine.llm_cache._asdict()),
                draft_gib=_tree_gib(engine.ssm_params) + _tree_gib(engine.ssm_cache._asdict()),
                top=sorted(k for k in engine.llm_params if k != "layers"),
                layers=engine._pp.layers, allocated_gib=torch.cuda.memory_allocated() / 2**30)
    hops0, bytes0 = mesh.hops, mesh.hop_bytes
    managers = _spec_managers(engine)
    reqs, st = _served(managers[1], _prompts(vspec.vocab_size), PP_SPEC_NEW, vspec.vocab_size,
                       f"pp (d) speculative P={mesh.pipe}", warm=managers[0], replayed=False)
    st.update(held, tokens=[r.output_tokens for r in reqs], build_s=build_s,
              hops=mesh.hops - hops0, hop_bytes=mesh.hop_bytes - bytes0,
              spec_horizon=managers[1].spec_horizon,
              mean_verified_tokens_per_step=managers[1].mean_verified_tokens_per_step)
    return st


PP_CASES = {"pp-a": _pp_case_a, "pp-b": _pp_case_b, "pp-d": _pp_case_d}


def _pp_one_device_int4(dev) -> dict:
    """(b)'s one-device run at the same settings: the same draw, quantized
    whole (``_quant_params``), InferenceEngine with the same chunk budget."""
    import torch

    from flexflow_tpu_torch.serving.engine import InferenceEngine
    from flexflow_tpu_torch.serving.request_manager import RequestManager
    from flexflow_tpu_torch.specs import ModelSpec

    spec = ModelSpec(**{**LLAMA2_7B, "num_layers": PP_INT4_LAYERS})
    engine = InferenceEngine(spec, _quant_params(spec, 0, dev, bits=4),
                             max_requests_per_batch=8, max_seq_len=1024,
                             max_tokens_per_batch=PP_CHUNK, cache_dtype=torch.bfloat16,
                             device=dev)
    rm = RequestManager(engine, decode_horizon=16, pipelined=True)
    try:
        reqs, st = _served(rm, _prompts(spec.vocab_size), 64, spec.vocab_size,
                           "pp (b) one device")
    finally:
        rm.close()
    st["tokens"] = [r.output_tokens for r in reqs]
    del engine, rm
    gc.collect()
    torch.cuda.empty_cache()
    return st


def _pp_one_device_spec(dev) -> None:
    """The spec phase's one-draft run (``_SPEC_SERVED``), for (d) when the
    spec phase is not selected."""
    import torch

    from flexflow_tpu_torch.serving.speculative import SpecEngine

    dspec, vspec, dparams, vparams = _spec_pair(dev)
    engine = SpecEngine(vspec, vparams, dspec, dparams, beam_width=3, beam_depth=4,
                        max_requests_per_batch=8, max_seq_len=1024, cache_dtype=torch.bfloat16,
                        device=dev)
    managers = _spec_managers(engine)
    reqs, st = _served(managers[1], _prompts(vspec.vocab_size), 64, vspec.vocab_size,
                       "pp (d) one device", warm=managers[0])
    _SPEC_SERVED.update(tokens=[r.output_tokens for r in reqs], decode_tok_s=st["decode_tok_s"],
                        verified=managers[1].mean_verified_tokens_per_step)
    del engine, managers, vparams, dparams
    gc.collect()
    torch.cuda.empty_cache()


def _pp_spec_check(what: str, ranks: list, card: str) -> dict:
    """(d): every rank's tokens equal, every request's ``PP_SPEC_NEW`` tokens
    bitwise the first of the spec phase's one-device run's, more than one
    verified token a step;
    each rank's layers, verifier KV and draft beside one device's; the hops;
    qmm_int4, decode_attention and flash_prefill launched."""
    rs = [r["pp-d"] for r in ranks]
    p, ref, label = len(rs), _SPEC_SERVED, "(d) speculative, LLaMA-2-7B INT4 + 160M draft"
    require(all(r["tokens"] == rs[0]["tokens"] for r in rs[1:]),
            f"pp {label} {what}: the ranks disagree on the tokens")
    want = [w[:PP_SPEC_NEW] for w in ref["tokens"]]
    apart = [i for i, (g, w) in enumerate(zip(rs[0]["tokens"], want)) if g != w]
    require(not apart, f"pp {label} {what}: requests {apart} differ from the spec phase's; "
                       f"common prefixes {_common_prefix(rs[0]['tokens'], want)}")
    layer_one, kv_one = sum(r["layer_gib"] for r in rs), sum(r["kv_gib"] for r in rs)
    depth = LLAMA2_7B["num_layers"] // p
    for s, r in enumerate(rs):
        require(r["layers"] == (s * depth, (s + 1) * depth),
                f"pp {label}: rank {s} holds layers {r['layers']}")
        log(f"  pp {label} {what} rank {s}: verifier layers {r['layers'][0]}-"
            f"{r['layers'][1] - 1}, {r['layer_gib']:.3f} GiB of layers (one device "
            f"{layer_one:.3f}), {r['kv_gib']:.3f} GiB of KV cache (one device {kv_one:.3f}), "
            f"top leaves {r['top']} {r['top_gib']:.3f} GiB, the whole draft and its cache "
            f"{r['draft_gib']:.3f} GiB (as one device holds it), {r['allocated_gib']:.3f} GiB "
            f"allocated after the build; {r['hops']} hops sent, {r['hop_bytes']} bytes (the "
            "warm-up request included)")
    st = rs[0]
    require(st["mean_verified_tokens_per_step"] > 1,
            f"pp {label}: mean verified tokens per step {st['mean_verified_tokens_per_step']}")
    out = dict(decode_tok_s=st["decode_tok_s"], one_device_tok_s=ref["decode_tok_s"],
               wall_s=st["wall_s"], seconds=st["seconds"], build_s=[r["build_s"] for r in rs],
               layer_gib=[r["layer_gib"] for r in rs], kv_gib=[r["kv_gib"] for r in rs],
               draft_gib=[r["draft_gib"] for r in rs], hops=[r["hops"] for r in rs],
               hop_bytes=[r["hop_bytes"] for r in rs],
               mean_verified_tokens_per_step=st["mean_verified_tokens_per_step"],
               launches={k: sum(r["launches"][k] for r in rs) for k in rs[0]["launches"]})
    log(f"  pp {label} {what}: every request's {PP_SPEC_NEW} tokens bitwise equal to the "
        "first of the spec phase's "
        f"({len(ref['tokens'])} of {len(ref['tokens'])}); "
        f"{st['mean_verified_tokens_per_step']:.3f} verified tokens a step (horizon "
        f"{st['spec_horizon']}); decode "
        f"{st['decode_tok_s']:.1f} tok/s against the spec phase's {ref['decode_tok_s']:.1f} "
        f"(no pipeline speed: two ranks share one card over gloo, every iteration eager); mean "
        f"TTFT {st['mean_ttft_ms']:.1f} ms; run wall {st['wall_s']:.2f} s, builds "
        f"{[round(r['build_s'], 1) for r in rs]} s, case {st['seconds']:.1f} s [{card}]")
    log(f"  launches during pp {label} {what}, every rank's: {json.dumps(out['launches'])}")
    for k in ("qmm_int4", "decode_attention", "flash_prefill"):
        require(out["launches"][k] > 0, f"pp {label}: {k} was never launched")
    return out


def _pp_check(what: str, ranks: list, one: dict, card: str) -> dict:
    """Every rank's tokens equal, every request's 64 tokens bitwise one
    device's (the serve phase's for (a), (b)'s one-device run); each rank's
    layers, cache and top leaves beside one device's; the hops."""
    p = len(ranks)
    out = {}
    for case, ref, label in (("pp-a", _SERVED, "(a) LLaMA-2-7B INT8"),
                             ("pp-b", one, f"(b) INT4 {PP_INT4_LAYERS} layers, chunked")):
        rs = [r[case] for r in ranks]
        require(all(r["tokens"] == rs[0]["tokens"] for r in rs[1:]),
                f"pp {label} {what}: the ranks disagree on the tokens")
        apart = [i for i, (g, w) in enumerate(zip(rs[0]["tokens"], ref["tokens"])) if g != w]
        require(not apart, f"pp {label} {what}: requests {apart} differ from one device's; "
                           f"common prefixes {_common_prefix(rs[0]['tokens'], ref['tokens'])}")
        layer_one = sum(r["layer_gib"] for r in rs)
        kv_one = sum(r["kv_gib"] for r in rs)
        depth = (LLAMA2_7B["num_layers"] if case == "pp-a" else PP_INT4_LAYERS) // p
        for s, r in enumerate(rs):
            require(r["layers"] == (s * depth, (s + 1) * depth),
                    f"pp {label}: rank {s} holds layers {r['layers']}")
            want_top = (["embed_tokens"] if s == 0 else []) + (
                ["final_norm_scale", "lm_head"] if s == p - 1 else [])
            require(r["top"] == want_top, f"pp {label}: rank {s} holds top leaves {r['top']}")
            log(f"  pp {label} {what} rank {s}: layers {r['layers'][0]}-{r['layers'][1] - 1}, "
                f"{r['layer_gib']:.3f} GiB of layers (one device {layer_one:.3f}), "
                f"{r['kv_gib']:.3f} GiB of KV cache (one device {kv_one:.3f}), top leaves "
                f"{r['top']} {r['top_gib']:.3f} GiB, {r['allocated_gib']:.3f} GiB allocated "
                f"after the build; {r['hops']} hops sent, {r['hop_bytes']} bytes "
                "(the warm-up request included)")
        st = rs[0]
        log(f"  pp {label} {what}: every request's 64 tokens bitwise equal to one device's "
            f"({len(ref['tokens'])} of {len(ref['tokens'])}); decode "
            f"{st['decode_tok_s']:.1f} tok/s against one device's {ref['decode_tok_s']:.1f} "
            f"(two ranks share one card over gloo: no pipeline speed); mean TTFT "
            f"{st['mean_ttft_ms']:.1f} ms; run wall {st['wall_s']:.2f} s, build "
            f"{st['build_s']:.1f} s, case {st['seconds']:.1f} s [{card}]")
        out[case] = dict(decode_tok_s=st["decode_tok_s"], one_device_tok_s=ref["decode_tok_s"],
                         wall_s=st["wall_s"], seconds=st["seconds"],
                         layer_gib=[r["layer_gib"] for r in rs],
                         kv_gib=[r["kv_gib"] for r in rs], hops=[r["hops"] for r in rs],
                         hop_bytes=[r["hop_bytes"] for r in rs],
                         launches={k: sum(r["launches"][k] for r in rs)
                                   for k in rs[0]["launches"]})
        log(f"  launches during pp {label} {what}, every rank's: "
            f"{json.dumps(out[case]['launches'])}")
        for k in ("qmm_int8" if case == "pp-a" else "qmm_int4", "decode_attention",
                  "flash_prefill"):
            require(out[case]["launches"][k] > 0, f"pp {label}: {k} was never launched")
    return out


def pp_phase(card: str) -> dict:
    """Pipeline-parallel serving (see the module docstring, phase pp): the
    one-device references; two ranks sharing the card over gloo for (a),
    (b) and (d), spawned; (c) NCCL across GPUs when the machine has more
    than one."""
    import torch

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    out: dict = {"card": card}
    if "tokens" not in _SERVED:  # the serve phase did not run: its run here
        _one_device_served(dev, "pp one device")
    if "tokens" not in _SPEC_SERVED:  # the spec phase did not run: its one-draft run here
        _pp_one_device_spec(dev)
    one = _pp_one_device_int4(dev)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_pp_")
    t0 = time.perf_counter()
    try:
        ranks = _spawn_tp(2, "gloo", tmp, tuple(PP_CASES), 600)
        out["ranks_s"] = time.perf_counter() - t0
        out.update(_pp_check("P=2 over gloo", ranks, one, card))
        out["pp-d"] = _pp_spec_check("P=2 over gloo", ranks, card)
        n = torch.cuda.device_count()
        if n > 1:
            ranks = _spawn_tp(min(4, n), "nccl", tmp, tuple(PP_CASES), 600)
            out["c"] = dict(_pp_check(f"P={min(4, n)} over NCCL", ranks, one, card),
                            d=_pp_spec_check(f"P={min(4, n)} over NCCL", ranks, card))
        else:
            log(f"  pp (c) did not run: the machine shows {n} GPU (NCCL takes one device a rank)")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"  pp phase wall {out['seconds']:.1f} s, the spawned ranks' {out['ranks_s']:.1f} s of "
        f"it [{card}]")
    return out

# ---------------------------------------------------------------------------
# training under pipeline stages (the pptrain phase)
# ---------------------------------------------------------------------------

PT_LAYERS = 4  # (a), (b): LLaMA-2-7B width, f32, two layers a stage at P = 2
PT_MICROBATCHES = 2  # M = P
PT_SIZES = (3, 1)  # (b)'s uneven stages
# (a)'s losses against one device's Trainer: the microbatches' sums run in
# another order than one device's
PT_LOSS_REL = 1e-5
PT_PARAMS_REL = 1e-4  # (a)'s full_params() against one device's, of each leaf's magnitude
PT_LOGITS_REL = 1e-4  # (b)'s logits against one device's decoder.forward, of their magnitude


def _pt_case(mesh, dev, refs) -> dict:
    """(a) and (b) on this rank of a P = 2 mesh: the Trainer through the
    GPipe step, its gathered parameters, then ``pipeline_forward`` over
    PT_SIZES stages. Rank 0 then runs the one-device side of both."""
    import torch

    from flexflow_tpu_torch.models import decoder
    from flexflow_tpu_torch.models import params as params_lib
    from flexflow_tpu_torch.parallel.pipeline import pipeline_forward
    from flexflow_tpu_torch.specs import ModelSpec
    from flexflow_tpu_torch.training import SGDOptimizer, Trainer

    _launches(reset=True)
    spec = ModelSpec(**{**LLAMA2_7B, "num_layers": PT_LAYERS})
    params = params_lib.init_params(spec, torch.Generator(device=dev).manual_seed(0),
                                    torch.float32, dev)
    bx, by = _mt_batch(spec.vocab_size)
    tr = Trainer(spec, params, SGDOptimizer(lr=MT_SGD_LR), mesh=mesh, pipeline_stages=mesh.pipe,
                 num_microbatches=PT_MICROBATCHES)
    out = dict(rank_gib=_tree_gib(tr.params), one_gib=_tree_gib(params), stage=mesh.pipe_rank,
               layers=tr.shard.layers, top=sorted(k for k in tr.params if k != "layers"))
    hops0, bytes0 = mesh.hops, mesh.hop_bytes
    out["losses"], out["step_ms"] = _mt_trainer_run(tr, bx, by)
    out.update(hops=mesh.hops - hops0, hop_bytes=mesh.hop_bytes - bytes0,
               peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    # a collective: every rank gathers (pptrain (a); cp (j) skips it for time)
    full = tr.full_params() if mesh.seq == 1 else None
    del tr
    torch.cuda.empty_cache()
    tokens = torch.from_numpy(bx).to(dev)
    positions = torch.arange(tokens.shape[1], dtype=torch.int32, device=dev)[None].expand(
        *tokens.shape)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits = pipeline_forward(spec, params, tokens, positions, mesh=mesh,
                              num_microbatches=PT_MICROBATCHES, stage_sizes=PT_SIZES)
    torch.cuda.synchronize()
    out["uneven_ms"] = 1e3 * (time.perf_counter() - t0)
    out["launches"] = _launches()
    if mesh.rank == 0:
        with torch.no_grad():
            want, _ = decoder.forward(spec, params, tokens, positions)
        out["uneven_rel"] = ((logits - want).abs().max() / want.abs().max()).item()
        out["logits_shape"] = tuple(logits.shape)
        out["logits_finite"] = bool(torch.isfinite(logits).all())
        del want, logits
        ref = Trainer(spec, params, SGDOptimizer(lr=MT_SGD_LR), device=dev)
        out["ref_losses"], out["ref_step_ms"] = _mt_trainer_run(ref, bx, by)
        if full is not None:
            mine = dict(_param_leaves(full))
            worst, worst_leaf = 0.0, ""
            for name, want in _param_leaves(ref.params):
                rel = ((mine.pop(name) - want.detach()).abs().max()
                       / want.detach().abs().max()).item()
                if rel > worst:
                    worst, worst_leaf = rel, name
            out.update(params_rel=worst, params_worst_leaf=worst_leaf, params_extra=sorted(mine))
        del ref
    del full, params
    gc.collect()
    torch.cuda.empty_cache()
    return out


PT_CASES = {"pt": _pt_case}


def _pt_check(what: str, ranks: list, card: str) -> dict:
    """Every rank's losses equal; rank 0's against one device; each rank's
    stage, leaves, GiB and hops; no port kernel launched."""
    p, r0 = len(ranks), ranks[0]["pt"]
    rs = [r["pt"] for r in ranks]
    require(all(r["losses"] == r0["losses"] for r in rs[1:]),
            f"pptrain {what}: the ranks disagree on the losses")
    rel = max(abs(a - b) / abs(b) for a, b in zip(r0["losses"], r0["ref_losses"]))
    require(rel <= PT_LOSS_REL, f"pptrain (a) {what}: losses {r0['losses']} against one "
                                f"device's {r0['ref_losses']}")
    require(r0["params_rel"] <= PT_PARAMS_REL and not r0["params_extra"],
            f"pptrain (a) {what}: full_params {r0['params_worst_leaf']} off by "
            f"{r0['params_rel']} of its magnitude, extra leaves {r0['params_extra']}")
    require(r0["logits_finite"] and r0["logits_shape"] == (TRAIN_BATCH, TRAIN_LEN,
                                                           LLAMA2_7B["vocab_size"]),
            f"pptrain (b) {what}: logits {r0['logits_shape']}, finite {r0['logits_finite']}")
    require(r0["uneven_rel"] <= PT_LOGITS_REL,
            f"pptrain (b) {what}: stages {PT_SIZES} logits {r0['uneven_rel']} off one device's")
    one_gib = r0["one_gib"]
    depth = PT_LAYERS // p
    for s, r in enumerate(rs):
        want_top = (["embed_tokens"] if s == 0 else []) + (
            ["final_norm_scale", "lm_head"] if s == p - 1 else [])
        require(tuple(r["layers"]) == (s * depth, (s + 1) * depth) and r["top"] == want_top,
                f"pptrain {what}: rank {s} holds layers {r['layers']} and top leaves {r['top']}")
        require(r["hops"] == MT_STEPS * PT_MICROBATCHES,
                f"pptrain {what}: rank {s} sent {r['hops']} hops")
        launched = {k: v for k, v in r["launches"].items() if v}
        require(not launched, f"pptrain {what}: rank {s} launched port kernels {launched}")
        log(f"  pptrain (a) {what} rank {s}: layers {r['layers'][0]}-{r['layers'][1] - 1} and "
            f"{r['top']}, {r['rank_gib']:.3f} GiB of parameters against one device's "
            f"{one_gib:.3f} ({r['rank_gib'] / one_gib:.1%}); sent {r['hops']} "
            f"{'forward' if s < p - 1 else 'backward'} hops, {r['hop_bytes']} bytes "
            f"({'hidden states' if s < p - 1 else 'their gradients'}); peak "
            f"{r['peak_gib']:.2f} GiB allocated [{card}]")
    require(abs(sum(r["rank_gib"] for r in rs) - one_gib) < 1e-6 and
            max(r["rank_gib"] for r in rs) <= 0.6 * one_gib,
            f"pptrain {what}: the ranks hold {[r['rank_gib'] for r in rs]} GiB of {one_gib}")
    step = sum(r0["step_ms"][1:]) / (MT_STEPS - 1)
    ref_step = sum(r0["ref_step_ms"][1:]) / (MT_STEPS - 1)
    log(f"  pptrain (a) P={p} M={PT_MICROBATCHES} {what}, {PT_LAYERS} layers, {TRAIN_BATCH} x "
        f"{TRAIN_LEN} tokens, {MT_STEPS} SGD steps: losses {r0['losses']} against one device's "
        f"{r0['ref_losses']} (within {rel:.3g} relative), full_params within "
        f"{r0['params_rel']:.3g} of each leaf's magnitude; step {step:.1f} ms against one "
        f"device's {ref_step:.1f} (steps after the first; two ranks share one card over gloo: "
        f"no pipeline speed) [{card}]")
    log(f"  pptrain (b) {what}: pipeline_forward over stages {list(PT_SIZES)}: logits within "
        f"{r0['uneven_rel']:.3g} of one device's magnitude, {r0['uneven_ms']:.1f} ms [{card}]")
    return dict(losses=r0["losses"], ref_losses=r0["ref_losses"], loss_rel=rel,
                params_rel=r0["params_rel"], uneven_rel=r0["uneven_rel"], step_ms=step,
                ref_step_ms=ref_step, rank_gib=[r["rank_gib"] for r in rs], one_gib=one_gib,
                hops=[r["hops"] for r in rs], hop_bytes=[r["hop_bytes"] for r in rs],
                uneven_ms=r0["uneven_ms"], seconds=[r["seconds"] for r in rs])


def pptrain_phase(card: str) -> dict:
    """Training under pipeline stages (see the module docstring, phase
    pptrain): two ranks sharing the card over gloo, spawned; (c) NCCL over
    two GPUs when the machine has them."""
    import torch

    t_phase = time.perf_counter()
    out: dict = {"card": card}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_pt_")
    try:
        out.update(_pt_check("over gloo", _spawn_tp(2, "gloo", tmp, tuple(PT_CASES), 600), card))
        n = torch.cuda.device_count()
        if n > 1:
            out["c"] = _pt_check("over NCCL", _spawn_tp(2, "nccl", tmp, tuple(PT_CASES), 600),
                                 card)
        else:
            log(f"  pptrain (c) did not run: the machine shows {n} GPU (NCCL takes one device a "
                "rank)")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"  pptrain phase wall {out['seconds']:.1f} s [{card}]")
    return out


# ---------------------------------------------------------------------------
# context parallelism (the cp phase)
# ---------------------------------------------------------------------------

CP_F32_LAYERS = 4  # (c): LLaMA-2-7B width, f32 weights and cache
CP_NEW = 24  # (a), (b), (f): new tokens a request (cut from the serve traffic's 64 for time)
# (c)'s prompts: the served lengths with 500 in place of 400, whose 32 new
# tokens cross position 512, the shard boundary at C = 2 (600 crosses it in
# its prefill)
CP_F32_LENS = (600, 500, 256, 128, 100, 64, 32, 17)
CP_F32_NEW = 32
# (b): the share of the spec phase's tokens that must come out equal. The C
# states merged in another order than one device's chunks may flip a bf16
# near-tie in the tree's verification, after which a request goes its own way
# (500 of 512 equal on an H100, PR 23's chip runs); a wrong tree path in the
# shard form loses most of them
CP_SPEC_EQUAL = 0.9
# (b): verified tokens a step within this share of the spec phase's (1.645
# against 1.638 on an H100, PR 23's chip runs)
CP_SPEC_VERIFIED = 0.1
CP_RING = dict(s=4096, h=32, kh=32, d=128)  # (d): the ring prefill's shape, bf16
CP_RING_LENGTH = 3000  # (d): a valid length inside the last rank's block
CP_RING_TOL = 2e-2  # (d): JAX's bf16 tolerance for the ring prefill (tests/test_ring_attention.py)


def _cp_prefill_logits(engine, prompts):
    """The engine's batched prefill of ``prompts`` into slots 0... (greedy),
    then one decode step of the first tokens through ``decoder.forward_cached``:
    (first tokens [N], that step's f32 logits [N, V])."""
    import numpy as np
    import torch

    from flexflow_tpu_torch.models import decoder
    from flexflow_tpu_torch.models.decoder import to_device

    n = len(prompts)
    with torch.no_grad():
        first = engine.prefill_batch_to_slots_async(prompts, list(range(n)), 0,
                                                    _greedy_scfg(n))[:n]
        lens = to_device(np.asarray([len(p) for p in prompts], np.int32), engine.device)
        logits, _ = decoder.forward_cached(engine.spec, engine.params, first[:, None].int(),
                                           engine.cache, lens, **engine._routing(None))
    return first.cpu(), logits[:, 0].float().cpu()


def _cp_case_a(mesh, dev, refs) -> dict:
    """(a): LLaMA-2-7B INT8, 32 layers, at C = seq ranks: the serve phase's
    draw (whole bf16 leaves from seed 0), each layer quantized whole
    (``build_params(mesh=)``: the weights are replicated over seq), the
    verifier cache cut on its positions; the first decode step's logits
    beside one device's on the same tensors, then the serve traffic."""
    import torch

    from flexflow_tpu_torch.models import params as params_lib
    from flexflow_tpu_torch.serving.engine import InferenceEngine
    from flexflow_tpu_torch.serving.request_manager import RequestManager
    from flexflow_tpu_torch.specs import ModelSpec

    t0 = time.perf_counter()
    spec = ModelSpec(**LLAMA2_7B)
    whole = params_lib.init_params(spec, torch.Generator(device=dev).manual_seed(0),
                                   torch.bfloat16, dev)
    stack = whole.pop("layers")
    params = params_lib.build_params(spec, whole, lambda i: ((n, v[i]) for n, v in stack.items()),
                                     dtype=torch.bfloat16, device=dev, bits=8, group_size=128,
                                     mesh=mesh)
    del whole, stack
    torch.cuda.empty_cache()
    kw = dict(max_requests_per_batch=8, max_seq_len=1024, cache_dtype=torch.bfloat16,
              device=dev)
    engine = InferenceEngine(spec, params, mesh=mesh, **kw)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    prompts = _prompts(spec.vocab_size)
    one = InferenceEngine(spec, engine.params, **kw)  # one device, the same weight tensors
    first_one, logits_one = _cp_prefill_logits(one, prompts)
    kv_one = _tree_gib(one.cache._asdict())
    del one
    gc.collect()
    torch.cuda.empty_cache()
    first, logits = _cp_prefill_logits(engine, prompts)
    rm = RequestManager(engine, decode_horizon=16, pipelined=True)
    try:
        reqs, st = _served(rm, prompts, CP_NEW, spec.vocab_size, f"cp (a) C={mesh.seq}",
                           replayed=False)
    finally:
        rm.close()
    st.update(tokens=[r.output_tokens for r in reqs], build_s=build_s,
              kv_gib=_tree_gib(engine.cache._asdict()), kv_one_gib=kv_one,
              positions=engine.cache.k.shape[3], first=first.tolist(),
              first_one=first_one.tolist(),
              logits_rel=((logits - logits_one).abs().max() / logits_one.abs().max()).item(),
              allocated_gib=torch.cuda.memory_allocated() / 2**30)
    return st


def _cp_case_b(mesh, dev, refs) -> dict:
    """(b): the spec phase's pair (LLaMA-2-7B INT4 verifier, 160M-class
    draft) through ``SpecEngine`` at C = seq ranks: the verifier's cache
    cut, the draft's whole; the spec phase's managers and traffic."""
    import torch

    from flexflow_tpu_torch.serving.speculative import SpecEngine

    t0 = time.perf_counter()
    dspec, vspec, dparams, vparams = _spec_pair(dev)
    engine = SpecEngine(vspec, vparams, dspec, dparams, beam_width=3, beam_depth=4,
                        max_requests_per_batch=8, max_seq_len=1024, cache_dtype=torch.bfloat16,
                        device=dev, mesh=mesh)
    del vparams, dparams
    gc.collect()
    torch.cuda.empty_cache()
    build_s = time.perf_counter() - t0
    managers = _spec_managers(engine)
    reqs, st = _served(managers[1], _prompts(vspec.vocab_size), CP_NEW, vspec.vocab_size,
                       f"cp (b) speculative C={mesh.seq}", warm=managers[0], replayed=False)
    st.update(tokens=[r.output_tokens for r in reqs], build_s=build_s,
              kv_gib=_tree_gib(engine.llm_cache._asdict()),
              draft_kv_gib=_tree_gib(engine.ssm_cache._asdict()),
              mean_verified_tokens_per_step=managers[1].mean_verified_tokens_per_step)
    return st


def _cp_case_c(mesh, dev, refs) -> dict:
    """(c): LLaMA-2-7B width at CP_F32_LAYERS layers in f32 (weights from
    seed 0, cache f32), the prompts of CP_F32_LENS: one device's engine on
    the same tensors first, then C = seq ranks'."""
    import numpy as np
    import torch

    from flexflow_tpu_torch.models import params as params_lib
    from flexflow_tpu_torch.serving.engine import InferenceEngine
    from flexflow_tpu_torch.serving.request_manager import RequestManager
    from flexflow_tpu_torch.specs import ModelSpec

    spec = ModelSpec(**{**LLAMA2_7B, "num_layers": CP_F32_LAYERS})
    params = params_lib.init_params(spec, torch.Generator(device=dev).manual_seed(0),
                                    torch.float32, dev)
    kw = dict(max_requests_per_batch=8, max_seq_len=1024, cache_dtype=torch.float32, device=dev)
    engine = InferenceEngine(spec, params, mesh=mesh, **kw)
    del params
    rng = np.random.RandomState(11)
    prompts = [rng.randint(1, spec.vocab_size, size=n).tolist() for n in CP_F32_LENS]
    out = {}
    for name, eng in (("one", InferenceEngine(spec, engine.params, **kw)), ("cp", engine)):
        rm = RequestManager(eng, decode_horizon=16, pipelined=True)
        try:
            reqs, st = _served(rm, prompts, CP_F32_NEW, spec.vocab_size,
                               f"cp (c) f32 {'one device' if name == 'one' else 'C=2'}",
                               replayed=name == "one")
        finally:
            rm.close()
        out[name] = dict(tokens=[r.output_tokens for r in reqs], decode_tok_s=st["decode_tok_s"])
        del rm, eng
        gc.collect()
        torch.cuda.empty_cache()
    out["launches"] = st["launches"]  # the C = 2 run's
    return out


def _cp_case_d(mesh, dev, refs) -> dict:
    """(d): ``ops/ring_attention.context_parallel_prefill`` over the seq ranks
    (bf16 [S, H, D], K/V blocks rotated along the ring) with and without a
    valid length, against the one-device plain prefill on the same inputs."""
    import torch

    from flexflow_tpu_torch.ops import attention as attn_lib
    from flexflow_tpu_torch.ops import ring_attention as ring

    gen = torch.Generator(device=dev).manual_seed(9)
    s, h, kh, d = CP_RING["s"], CP_RING["h"], CP_RING["kh"], CP_RING["d"]
    q = torch.randn(s, h, d, generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn(s, kh, d, generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn(s, kh, d, generator=gen, device=dev).to(torch.bfloat16)
    out = {}
    for length in (None, CP_RING_LENGTH):
        hops0 = mesh.hops
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = ring.context_parallel_prefill(mesh, q, k, v, length=length)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        want = attn_lib.prefill_attention(q, k, v, length=length)
        out[f"length={length}"] = dict(
            err=(got.float() - want.float()).abs().max().item(), wall_ms=1e3 * wall,
            hops=mesh.hops - hops0, finite=bool(torch.isfinite(got).all()),
            dtype=str(got.dtype))
        del got, want
        torch.cuda.empty_cache()
    return out


def _digest(tensors) -> str:
    """sha256 of the tensors' bytes, in order (on the host)."""
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().float().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _cp_lora_run(engine, spec, cfg, what: str) -> dict:
    """The serve prompts x CP_NEW routed LORA_IDS through ``engine`` with a
    finetuning session on slot MT_FT_SLOT registered beside it (meshtrain
    (d) + (e)): the tokens, the run's stats, the losses, the slot and its
    digest."""
    from flexflow_tpu_torch.peft.finetune import FinetuneSession
    from flexflow_tpu_torch.serving.request_manager import RequestManager

    session = FinetuneSession(spec, cfg, MT_FT_SLOT,
                              _finetune_data(spec.vocab_size)[:MT_FT_STEPS], epochs=1)
    rm = RequestManager(engine, decode_horizon=16, pipelined=True)
    try:
        reqs, st = _served(rm, _prompts(spec.vocab_size), CP_NEW, spec.vocab_size, what,
                           adapters=LORA_IDS, session=session,
                           replayed=engine.graphs is not None)
    finally:
        rm.close()
    slot = _mt_slot(engine, spec)
    st.update(tokens=[r.output_tokens for r in reqs], losses=session.losses, slot=slot,
              slot_digest=_digest([t for ab in slot.values() for t in ab.values()]))
    return st


def _cp_case_f(mesh, dev, refs) -> dict:
    """(f): meshtrain (d)'s LoRA model (LLaMA-2-7B INT8 at MT_LORA_LAYERS
    layers, MT_LORA_DTYPE, the lora phase's four adapters) at C = seq ranks,
    the serve prompts x CP_NEW routed LORA_IDS with a finetuning session on
    slot MT_FT_SLOT beside it. Rank 0 first runs one device on the same weight
    tensors and a second draw of the same adapters."""
    import torch

    from flexflow_tpu_torch.serving.engine import InferenceEngine

    spec, engine, cfg = _mt_lora_model(mesh, dev)
    out = {}
    if mesh.rank == 0:
        lora, _ = _lora_adapters(spec, 4, dev, seed=1, lr=MT_FT_LR)
        one = InferenceEngine(spec, engine.params, max_requests_per_batch=8, max_seq_len=1024,
                              max_tokens_per_batch=0, cache_dtype=engine.cache.k.dtype,
                              device=dev, lora=lora, lora_config=cfg)
        del lora
        st = _cp_lora_run(one, spec, cfg, f"cp (f) LoRA one device, {MT_LORA_LAYERS} layers")
        out["one"] = {k: st[k] for k in ("tokens", "losses", "slot_digest", "decode_tok_s")}
        del one, st
        gc.collect()
        torch.cuda.empty_cache()
    out.update(_cp_lora_run(engine, spec, cfg, f"cp (f) LoRA C={mesh.seq} with finetuning"),
               kv_gib=_tree_gib(engine.cache._asdict()), positions=engine.cache.k.shape[3])
    out.pop("slot")
    return out


def _cp_case_g(mesh, dev, refs) -> dict:
    """(g): layouts (a)'s LLaMA-2-7B INT8 at LAYOUT_OFFLOAD_LAYERS layers at
    C = seq ranks, resident then offload over one pinned build (the weights
    whole on each seq rank), the cache cut on seq."""
    from flexflow_tpu_torch.specs import ModelSpec

    spec = ModelSpec(**{**LLAMA2_7B, "num_layers": LAYOUT_OFFLOAD_LAYERS})
    out = _la_offload_pair(spec, mesh, dev, LAYOUT_NEW_TOKENS, f"cp (g) offload C={mesh.seq}")
    out.pop("logits")
    return out


CP_CASES = {"cp-a": _cp_case_a, "cp-b": _cp_case_b, "cp-c": _cp_case_c, "cp-d": _cp_case_d,
            "cp-f": _cp_case_f, "cp-g": _cp_case_g, "cp-h": _mt_train}
CP_PP_LIMIT_S = 600  # (i), (j): the four-rank spawn's time limit
CP_PP_MICROBATCHES = 2  # (i): M = P, the overlapped horizon
CP_REL = 1e-6  # (f)'s finetuning and (h)'s Trainer losses against one device's, relative


def _cp_case_i(mesh, dev, refs) -> dict:
    """(i): (c)'s LLaMA-2-7B width at CP_F32_LAYERS layers in f32 (weights
    from seed 0, cache f32) through ``PipelineInferenceEngine`` on a P x C
    mesh: every seq coordinate a copy of the stages, each stage's cache
    whole. Rank 0 first runs one device's engine on the same tensors."""
    import numpy as np
    import torch

    from flexflow_tpu_torch.models import params as params_lib
    from flexflow_tpu_torch.parallel.mesh import PIPE_AXIS
    from flexflow_tpu_torch.serving.engine import InferenceEngine
    from flexflow_tpu_torch.serving.pp_engine import PipelineInferenceEngine
    from flexflow_tpu_torch.serving.request_manager import RequestManager
    from flexflow_tpu_torch.specs import ModelSpec

    spec = ModelSpec(**{**LLAMA2_7B, "num_layers": CP_F32_LAYERS})
    params = params_lib.init_params(spec, torch.Generator(device=dev).manual_seed(0),
                                    torch.float32, dev)
    kw = dict(max_requests_per_batch=8, max_seq_len=1024, cache_dtype=torch.float32, device=dev)
    rng = np.random.RandomState(11)
    prompts = [rng.randint(1, spec.vocab_size, size=n).tolist() for n in CP_F32_LENS]
    out = {}
    if mesh.rank == 0:
        one = InferenceEngine(spec, params, **kw)
        rm = RequestManager(one, decode_horizon=16, pipelined=True)
        try:
            reqs, st = _served(rm, prompts, CP_F32_NEW, spec.vocab_size,
                               "cp (i) f32 one device", replayed=one.graphs is not None)
        finally:
            rm.close()
        out["one"] = dict(tokens=[r.output_tokens for r in reqs], decode_tok_s=st["decode_tok_s"],
                          kv_gib=_tree_gib(one.cache._asdict()),
                          layer_gib=_tree_gib(params["layers"]))
        del one, rm
        gc.collect()
        torch.cuda.empty_cache()
    engine = PipelineInferenceEngine(spec, params, mesh=mesh,
                                     num_microbatches=CP_PP_MICROBATCHES, **kw)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    held = dict(layer_gib=_tree_gib(engine.params["layers"]),
                kv_gib=_tree_gib(engine.cache._asdict()), cache=tuple(engine.cache.k.shape),
                layers=engine.layers, top=sorted(k for k in engine.params if k != "layers"),
                coord=(mesh.pipe_rank, mesh.seq_rank),
                pipe_ranks=mesh.group_ranks(PIPE_AXIS))
    hops0 = mesh.hops
    rm = RequestManager(engine, decode_horizon=16, pipelined=True)
    try:
        reqs, st = _served(rm, prompts, CP_F32_NEW, spec.vocab_size,
                           f"cp (i) f32 P={mesh.pipe} x C={mesh.seq}", replayed=False)
    finally:
        rm.close()
    out.update(st, **held, tokens=[r.output_tokens for r in reqs], hops=mesh.hops - hops0)
    return out


CP_PP_CASES = {"cp-i": _cp_case_i, "cp-j": _pt_case}


def _cp_check(what: str, ranks: list, card: str) -> dict:
    """Rank 0's (a)-(d) against one device's: (a) the ranks agree, every
    first token the serve phase's, each rank half the KV, the first decode
    step's logits beside one device's, the greedy tokens equal to the serve
    phase's counted; (b) the ranks agree, every first token the spec
    phase's, at least CP_SPEC_EQUAL of its tokens equal, verified tokens a
    step within CP_SPEC_VERIFIED of its; (c) every f32 token one device's; (d) the ring
    prefill within CP_RING_TOL of the plain prefill."""
    c = len(ranks)
    out = {}
    rs = [r["cp-a"] for r in ranks]
    label = "(a) LLaMA-2-7B INT8"
    require(all(r["tokens"] == rs[0]["tokens"] for r in rs[1:]),
            f"cp {label} {what}: the ranks disagree on the tokens")
    st, ref = rs[0], _SERVED
    firsts = sum(g[0] == w[0] for g, w in zip(st["tokens"], ref["tokens"]))
    require(firsts == len(ref["tokens"]), f"cp {label} {what}: {firsts} of "
                                          f"{len(ref['tokens'])} first tokens equal the serve "
                                          "phase's")
    require(st["first"] == st["first_one"], f"cp {label}: the prefill's tokens differ")
    equal = sum(g == w for gs, ws in zip(st["tokens"], ref["tokens"]) for g, w in zip(gs, ws))
    total = sum(len(g) for g in st["tokens"])  # the serve phase's first CP_NEW of each
    for s_, r in enumerate(rs):
        require(abs(r["kv_gib"] * c - r["kv_one_gib"]) < 1e-6 and r["positions"] == 1024 // c,
                f"cp {label}: rank {s_} holds {r['kv_gib']:.3f} GiB of KV, one device "
                f"{r['kv_one_gib']:.3f}")
        log(f"  cp {label} {what} rank {s_}: {r['kv_gib']:.3f} GiB of KV cache ({r['positions']} "
            f"positions a slot) against one device's {r['kv_one_gib']:.3f}; "
            f"{r['allocated_gib']:.3f} GiB allocated; first decode step's logits within "
            f"{r['logits_rel']:.3g} of one device's magnitude; build {r['build_s']:.1f} s")
    require(max(r["logits_rel"] for r in rs) <= TP_LOGITS_REL,
            f"cp {label}: the first decode step's logits apart from one device's")
    log(f"  cp {label} {what}: {firsts} of {len(ref['tokens'])} first tokens equal the serve "
        f"phase's; {equal} of {total} greedy tokens equal (bf16: the C states merged in another "
        f"order than one device's chunks flip near-ties, then the requests go their own way); "
        f"decode {st['decode_tok_s']:.1f} tok/s against one device's "
        f"{ref['decode_tok_s']:.1f} (no context-parallel speed: two gloo ranks share one card, "
        f"every step eager); mean TTFT {st['mean_ttft_ms']:.1f} ms [{card}]")
    out["a"] = dict(decode_tok_s=st["decode_tok_s"], one_device_tok_s=ref["decode_tok_s"],
                    first_equal=firsts, tokens_equal=equal, tokens=total,
                    kv_gib=[r["kv_gib"] for r in rs], kv_one_gib=rs[0]["kv_one_gib"],
                    logits_rel=[r["logits_rel"] for r in rs], seconds=st["seconds"],
                    launches={k: sum(r["launches"][k] for r in rs) for k in st["launches"]})
    rs = [r["cp-b"] for r in ranks]
    label, st, ref = "(b) speculative, LLaMA-2-7B INT4 + 160M draft", rs[0], _SPEC_SERVED
    require(all(r["tokens"] == rs[0]["tokens"] for r in rs[1:]),
            f"cp {label} {what}: the ranks disagree on the tokens")
    want = [w[:CP_NEW] for w in ref["tokens"]]  # the spec phase's first CP_NEW of each
    firsts = sum(g[0] == w[0] for g, w in zip(st["tokens"], want))
    require(firsts == len(want),
            f"cp {label} {what}: {firsts} of {len(want)} first tokens equal the spec phase's")
    equal = sum(g == w for gs, ws in zip(st["tokens"], want) for g, w in zip(gs, ws))
    total = sum(len(w) for w in want)
    same = sum(g == w for g, w in zip(st["tokens"], want))
    require(equal >= CP_SPEC_EQUAL * total,
            f"cp {label} {what}: {equal} of {total} tokens equal the spec phase's "
            f"(at least {CP_SPEC_EQUAL:.0%})")
    verified = st["mean_verified_tokens_per_step"]
    require(abs(verified - ref["verified"]) <= CP_SPEC_VERIFIED * ref["verified"],
            f"cp {label} {what}: {verified:.3f} verified tokens a step against the spec "
            f"phase's {ref['verified']:.3f} (within {CP_SPEC_VERIFIED:.0%})")
    log(f"  cp {label} {what}: {firsts} of {len(want)} first tokens, {same} of {len(want)} "
        f"requests and {equal} of {total} tokens equal the spec phase's; {verified:.3f} "
        f"verified tokens a step (the spec phase's {ref['verified']:.3f}); "
        f"verifier KV {st['kv_gib']:.3f} GiB a rank, the draft's whole {st['draft_kv_gib']:.3f}; "
        f"decode {st['decode_tok_s']:.1f} tok/s against {ref['decode_tok_s']:.1f} [{card}]")
    out["b"] = dict(decode_tok_s=st["decode_tok_s"], one_device_tok_s=ref["decode_tok_s"],
                    first_equal=firsts, requests_equal=same, tokens_equal=equal, tokens=total,
                    mean_verified_tokens_per_step=verified,
                    launches={k: sum(r["launches"][k] for r in rs) for k in st["launches"]})
    rs = [r["cp-c"] for r in ranks]
    label = f"(c) f32, {CP_F32_LAYERS} layers"
    st = rs[0]
    apart = [i for i, (g, w) in enumerate(zip(st["cp"]["tokens"], st["one"]["tokens"])) if g != w]
    require(not apart and all(r["cp"]["tokens"] == st["cp"]["tokens"] for r in rs),
            f"cp {label} {what}: requests {apart} differ from one device's; common prefixes "
            f"{_common_prefix(st['cp']['tokens'], st['one']['tokens'])}")
    log(f"  cp {label} {what}: every greedy token of the {len(CP_F32_LENS)} requests x "
        f"{CP_F32_NEW} equal to one device's (prompt {CP_F32_LENS[1]} + {CP_F32_NEW} crosses "
        f"position {1024 // c}, {CP_F32_LENS[0]} in its prefill) [{card}]")
    out["c"] = dict(launches={k: sum(r["cp-c"]["launches"][k] for r in ranks)
                              for k in st["launches"]})
    out["d"] = {}
    for key, res in ranks[0]["cp-d"].items():
        if key == "seconds":
            continue
        require(res["finite"] and res["err"] <= CP_RING_TOL and res["dtype"] == "torch.bfloat16",
                f"cp (d) ring prefill {key}: max|err| {res['err']} (limit {CP_RING_TOL})")
        log(f"  cp (d) ring prefill S={CP_RING['s']} H={CP_RING['h']} D={CP_RING['d']} bf16 "
            f"{key} {what}: max|err| {res['err']:.3g} against the one-device plain prefill "
            f"(limit {CP_RING_TOL}); {res['hops']} ring hops a rank; {res['wall_ms']:.1f} ms "
            f"wall, gloo's host copies included [{card}]")
        out["d"][key] = res
    launches = out["a"]["launches"]
    log(f"  launches during cp (a) {what}, every rank's: {json.dumps(launches)}")
    for k in ("qmm_int8", "decode_attention_shard", "merge_states", "flash_prefill"):
        require(launches[k] > 0, f"cp (a): {k} was never launched")
    require(launches["decode_attention"] == 0, "cp (a): the one-device decode kernel launched")
    for k in ("qmm_int4", "decode_attention_shard", "merge_states"):
        require(out["b"]["launches"][k] > 0, f"cp (b): {k} was never launched")
    return out


def _cp_check_layouts(what: str, ranks: list, card: str) -> dict:
    """(f)-(h) of one spawned run: (f) every token of the LoRA run bitwise
    one device's, both ranks' losses and slot digests equal, the losses
    within CP_REL of one device's; (g) the offloaded tokens bitwise the
    resident C = 2 run's (required inside ``_la_offload_pair``), each
    rank's pinned and KV GiB; (h) both ranks' losses equal, within CP_REL of
    one device's."""
    c, out = len(ranks), {}
    fs = [r["cp-f"] for r in ranks]
    f, one = fs[0], fs[0]["one"]
    label = f"cp (f) LoRA + finetuning C={c} {what}, LLaMA-2-7B INT8 {MT_LORA_LAYERS} layers"
    for key in ("tokens", "losses", "slot_digest"):
        require(all(r[key] == f[key] for r in fs[1:]), f"{label}: the ranks disagree on {key}")
    apart = [i for i, (g, w) in enumerate(zip(f["tokens"], one["tokens"])) if g != w]
    require(not apart, f"{label}: requests {apart} differ from one device's; common prefixes "
                       f"{_common_prefix(f['tokens'], one['tokens'])}")
    rel = max(abs(a - b) / abs(b) for a, b in zip(f["losses"], one["losses"]))
    require(len(f["losses"]) == MT_FT_STEPS and rel <= CP_REL,
            f"{label}: losses {f['losses']} against one device's {one['losses']}")
    for k in ("qmm_int8", "decode_attention_shard", "merge_states", "flash_prefill"):
        require(f["launches"][k] > 0, f"{label}: {k} was never launched")
    require(f["launches"]["decode_attention"] == 0, f"{label}: the one-device decode kernel ran")
    log(f"  {label}: every token of the 8 requests (adapters {LORA_IDS}) x {CP_NEW} bitwise one "
        f"device's; {MT_FT_STEPS} SGD steps on slot {MT_FT_SLOT} beside the decode: losses "
        f"{f['losses']} (one device's {one['losses']}, within {rel:.3g} relative), the slot's "
        f"digest {'equal to' if f['slot_digest'] == one['slot_digest'] else 'apart from'} one "
        f"device's and both ranks'; KV {f['kv_gib']:.3f} GiB a rank ({f['positions']} "
        f"positions); decode {f['decode_tok_s']:.1f} tok/s against one device's "
        f"{one['decode_tok_s']:.1f} [{card}]")
    out["f"] = dict(losses=f["losses"], one_device_losses=one["losses"], loss_rel=rel,
                    slot_equal=f["slot_digest"] == one["slot_digest"],
                    decode_tok_s=f["decode_tok_s"], one_device_tok_s=one["decode_tok_s"],
                    kv_gib=f["kv_gib"], seconds=f["seconds"],
                    launches={k: sum(r["cp-f"]["launches"][k] for r in ranks)
                              for k in f["launches"]})
    gs = [r["cp-g"] for r in ranks]
    g = gs[0]
    label = f"cp (g) offload C={c} {what}, LLaMA-2-7B INT8 {LAYOUT_OFFLOAD_LAYERS} layers"
    for run in ("resident", "offload"):
        require(all(r[run]["tokens"] == g[run]["tokens"] for r in gs[1:]),
                f"{label}: the ranks disagree on the {run} tokens")
    for s_, r in enumerate(gs):
        log(f"  {label} rank {s_}: {r['pinned_gib']:.3f} GiB pinned, KV {r['kv_gib']:.3f} GiB, "
            f"copy alone {r['copy_alone_s']:.3f} s, an offload decode step "
            f"{r['step_wall_s']:.3f} s [{card}]")
    log(f"  {label}: every token of the offload run bitwise the resident C={c} run's (8 x "
        f"{LAYOUT_NEW_TOKENS}); decode {g['offload']['decode_tok_s']:.1f} tok/s offload against "
        f"{g['resident']['decode_tok_s']:.1f} resident [{card}]")
    out["g"] = dict(pinned_gib=[r["pinned_gib"] for r in gs], kv_gib=[r["kv_gib"] for r in gs],
                    copy_alone_s=[r["copy_alone_s"] for r in gs],
                    step_wall_s=[r["step_wall_s"] for r in gs], seconds=g["seconds"],
                    **{run: dict(decode_tok_s=g[run]["decode_tok_s"],
                                 launches={k: sum(r["cp-g"][run]["launches"][k] for r in ranks)
                                           for k in g[run]["launches"]})
                       for run in ("resident", "offload")})
    hs = [r["cp-h"] for r in ranks]
    h = hs[0]
    label = f"cp (h) Trainer C={c} {what}, {MT_RANK_LAYERS} layer"
    require(all(r["losses"] == h["losses"] for r in hs[1:]), f"{label}: the ranks' losses differ")
    rel = max(abs(a - b) / abs(b) for a, b in zip(h["losses"], h["ref_losses"]))
    require(rel <= CP_REL and h["params_rel"] <= PT_PARAMS_REL,
            f"{label}: losses {h['losses']} against one device's {h['ref_losses']}, "
            f"full_params {h['params_worst_leaf']} off by {h['params_rel']}")
    step = sum(h["step_ms"][1:]) / (MT_STEPS - 1)
    log(f"  {label}, {MT_STEPS} SGD steps: both ranks' losses {h['losses']} against one "
        f"device's {h['ref_losses']} ({'bitwise' if h['losses'] == h['ref_losses'] else f'within {rel:.3g} relative'}), "
        f"full_params within {h['params_rel']:.3g}; step {step:.1f} ms [{card}]")
    out["h"] = dict(losses=h["losses"], ref_losses=h["ref_losses"], loss_rel=rel,
                    params_rel=h["params_rel"], step_ms=step, seconds=h["seconds"])
    return out


def _cp_pp_check(what: str, ranks: list, card: str) -> dict:
    """(i) and (j) of the four-rank P = 2 x C = 2 spawn: (i) every rank's
    tokens bitwise one device's, each stage's seq ranks holding the stage's
    layers and its whole cache; (j) every rank's losses equal, within
    PT_LOSS_REL of one device's, each rank its stage's layers."""
    out = {}
    rs = [r["cp-i"] for r in ranks]
    i0, one = rs[0], rs[0]["one"]
    label = f"cp (i) PipelineInferenceEngine f32 {CP_F32_LAYERS} layers P=2 x C=2 {what}"
    require(all(r["tokens"] == i0["tokens"] for r in rs[1:]),
            f"{label}: the ranks disagree on the tokens")
    apart = [k for k, (g, w) in enumerate(zip(i0["tokens"], one["tokens"])) if g != w]
    require(not apart, f"{label}: requests {apart} differ from one device's; common prefixes "
                       f"{_common_prefix(i0['tokens'], one['tokens'])}")
    depth = CP_F32_LAYERS // 2
    for r, st in enumerate(rs):
        p, c = st["coord"]
        require(p == r // 2 and c == r % 2 and st["pipe_ranks"] == [c, 2 + c],
                f"{label}: rank {r} at stage {p}, seq {c}, pipe group {st['pipe_ranks']}")
        require(tuple(st["layers"]) == (p * depth, (p + 1) * depth)
                and st["cache"] == (depth, 8, LLAMA2_7B["num_kv_heads"], 1024,
                                    LLAMA2_7B["head_dim"]),
                f"{label}: rank {r} holds layers {st['layers']}, a cache {st['cache']}")
        log(f"  {label} rank {r} (stage {p}, seq {c}): layers {st['layers'][0]}-"
            f"{st['layers'][1] - 1}, {st['layer_gib']:.3f} GiB of layers, KV {st['kv_gib']:.3f} "
            f"GiB (the stage's whole cache, 1024 positions; one device's {one['kv_gib']:.3f}), "
            f"{st['hops']} hops sent [{card}]")
    for p in range(2):  # each stage's two seq ranks: the same residency
        a, b = rs[2 * p], rs[2 * p + 1]
        require(a["layers"] == b["layers"] and a["kv_gib"] == b["kv_gib"] and a["top"] == b["top"],
                f"{label}: stage {p}'s seq ranks hold different things")
    launches = {k: sum(r["launches"][k] for r in rs) for k in i0["launches"]}
    for k in ("decode_attention", "flash_prefill"):
        require(launches[k] > 0, f"{label}: {k} was never launched")
    require(launches["decode_attention_shard"] == 0, f"{label}: the shard form ran")
    log(f"  {label}: every greedy token of the {len(CP_F32_LENS)} requests x {CP_F32_NEW} "
        f"bitwise one device's on every rank; decode {i0['decode_tok_s']:.1f} tok/s against one "
        f"device's {one['decode_tok_s']:.1f} (four gloo ranks share one card, every step "
        f"eager) [{card}]")
    out["i"] = dict(decode_tok_s=i0["decode_tok_s"], one_device_tok_s=one["decode_tok_s"],
                    layer_gib=[r["layer_gib"] for r in rs], kv_gib=[r["kv_gib"] for r in rs],
                    one_kv_gib=one["kv_gib"], one_layer_gib=one["layer_gib"],
                    hops=[r["hops"] for r in rs], seconds=i0["seconds"], launches=launches)
    js = [r["cp-j"] for r in ranks]
    j0 = js[0]
    label = f"cp (j) Trainer P=2 x C=2 {what}, {PT_LAYERS} layers f32"
    require(all(r["losses"] == j0["losses"] for r in js[1:]),
            f"{label}: the ranks disagree on the losses")
    rel = max(abs(a - b) / abs(b) for a, b in zip(j0["losses"], j0["ref_losses"]))
    require(rel <= PT_LOSS_REL,
            f"{label}: losses {j0['losses']} against one device's {j0['ref_losses']}")
    require(j0["uneven_rel"] <= PT_LOGITS_REL,
            f"{label}: pipeline_forward over {PT_SIZES} off one device's by {j0['uneven_rel']}")
    depth = PT_LAYERS // 2
    for r, st in enumerate(js):
        p = r // 2
        require(st["stage"] == p and tuple(st["layers"]) == (p * depth, (p + 1) * depth)
                and st["hops"] == MT_STEPS * PT_MICROBATCHES,
                f"{label}: rank {r} at stage {st['stage']}, layers {st['layers']}, "
                f"{st['hops']} hops")
        launched = {k: v for k, v in st["launches"].items() if v}
        require(not launched, f"{label}: rank {r} launched port kernels {launched}")
    step = sum(j0["step_ms"][1:]) / (MT_STEPS - 1)
    log(f"  {label}, {MT_STEPS} SGD steps: every rank's losses {j0['losses']} against one "
        f"device's {j0['ref_losses']} (within {rel:.3g} relative; full_params is gathered "
        f"at P = 2 by pptrain (a), not here), pipeline_forward over {list(PT_SIZES)} within "
        f"{j0['uneven_rel']:.3g}; {[round(r['rank_gib'], 3) for r in js]} GiB a rank of "
        f"{j0['one_gib']:.3f}; step {step:.1f} ms [{card}]")
    out["j"] = dict(losses=j0["losses"], ref_losses=j0["ref_losses"], loss_rel=rel,
                    uneven_rel=j0["uneven_rel"], step_ms=step,
                    rank_gib=[r["rank_gib"] for r in js], seconds=j0["seconds"])
    return out


def _one_device_served(dev, what: str) -> None:
    """The serve phase's run (``_SERVED``) when that phase did not run."""
    import torch

    from flexflow_tpu_torch.serving.engine import InferenceEngine
    from flexflow_tpu_torch.serving.request_manager import RequestManager
    from flexflow_tpu_torch.specs import ModelSpec

    spec = ModelSpec(**LLAMA2_7B)
    engine = InferenceEngine(spec, _quant_params(spec, 0, dev), max_requests_per_batch=8,
                             max_seq_len=1024, max_tokens_per_batch=0,
                             cache_dtype=torch.bfloat16, device=dev)
    rm = RequestManager(engine, decode_horizon=16, pipelined=True)
    try:
        reqs, st = _served(rm, _prompts(spec.vocab_size), 64, spec.vocab_size, what)
    finally:
        rm.close()
    _SERVED.update(tokens=[r.output_tokens for r in reqs], decode_tok_s=st["decode_tok_s"],
                   mean_ttft_ms=st["mean_ttft_ms"])
    del engine, rm
    gc.collect()
    torch.cuda.empty_cache()


def cp_phase(card: str) -> dict:
    """Context parallelism (see the module docstring, phase cp): two ranks
    sharing the card over gloo for (a)-(d) and (f)-(h), spawned, then four
    for (i) and (j); (e) NCCL across GPUs when the machine has more than
    one."""
    import torch

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    out: dict = {"card": card}
    if "tokens" not in _SERVED:
        _one_device_served(dev, "cp one device")
    if "tokens" not in _SPEC_SERVED:
        _pp_one_device_spec(dev)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cp_")
    t0 = time.perf_counter()
    try:
        ranks = _spawn_tp(2, "gloo", tmp, tuple(CP_CASES), 600)
        out["ranks_s"] = time.perf_counter() - t0
        out.update(_cp_check("C=2 over gloo", ranks, card))
        out.update(_cp_check_layouts("over gloo", ranks, card))
        t0 = time.perf_counter()
        ranks = _spawn_tp(4, "gloo", tmp, tuple(CP_PP_CASES), CP_PP_LIMIT_S)
        out["pp_ranks_s"] = time.perf_counter() - t0
        out.update(_cp_pp_check("over gloo", ranks, card))
        n = torch.cuda.device_count()
        if n > 1:
            what, nccl = f"C={min(4, n)} over NCCL", _spawn_tp(min(4, n), "nccl", tmp,
                                                                tuple(CP_CASES), 600)
            out["e"] = {**_cp_check(what, nccl, card), **_cp_check_layouts(what, nccl, card)}
        else:
            log(f"  cp (e) did not run: the machine shows {n} GPU (NCCL takes one device a rank)")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"  cp phase wall {out['seconds']:.1f} s: the two spawned ranks' {out['ranks_s']:.1f} s "
        f"of it, the four P x C ranks' {out['pp_ranks_s']:.1f} s (their start included) "
        f"[{card}]")
    return out

# ---------------------------------------------------------------------------
# multi-process serving (parallel/distributed.py, the background server under
# a mesh: the dist phase)
# ---------------------------------------------------------------------------

DIST_LIMIT_S = 300  # each rank's time limit; the ranks are killed past it
DIST_NEW = 16  # new tokens a request (cut from the serve phase's 64 for the run's time)


def _dist_stats(reqs, t_end: float) -> dict:
    """TTFT and decode tok/s of ``reqs`` as their caller sees them (as
    ``_served``: tokens after each first one, from the last first token to
    ``t_end``)."""
    import numpy as np

    first = max(r.profile.first_token_time for r in reqs)
    return dict(mean_ttft_ms=1e3 * float(np.mean([r.profile.ttft for r in reqs])),
                decode_tok_s=sum(len(r.output_tokens) - 1 for r in reqs) / (t_end - first))


def _dist_rank(tmp: str) -> None:
    """One rank of the dist phase, a process of its own formed through
    ``init_distributed`` (the ``FF_*`` variables; gloo, card 0): LLaMA-2-7B
    INT8 at T = 2 (``_tp_llama``), then (a) ``serve_distributed`` and (b)
    ``LLM.start_server`` under the mesh; the results go to ``tmp``."""
    import threading

    import torch
    import torch.distributed as dist

    from flexflow_tpu_torch.parallel.distributed import (RequestBroadcaster, init_distributed,
                                                         is_controller, serve_distributed)
    from flexflow_tpu_torch.parallel.mesh import make_mesh
    from flexflow_tpu_torch.serve import LLM
    from flexflow_tpu_torch.serving.request_manager import GenerationConfig

    with open(f"{tmp}/dist.json") as f:
        ports = json.load(f)
    dev = torch.device("cuda", 0)
    init_distributed(device=dev, backend="gloo")
    ctrl, rank = is_controller(), dist.get_rank()
    if not ctrl:
        global log
        log = lambda *a: None  # noqa: E731 - rank 0 speaks for the mesh
    rm = None
    try:
        t0 = time.perf_counter()
        mesh = make_mesh(model=2, device=dev)
        spec, engine, rm = _tp_llama(mesh, dev)
        prompts = _prompts(spec.vocab_size)
        rm.generate([prompts[-1]], GenerationConfig(max_new_tokens=4))  # warm-up, SPMD
        torch.cuda.synchronize()
        out = {"build_s": time.perf_counter() - t0}

        # (a) the controller broadcasts the workload, every rank serves it
        bc = RequestBroadcaster(port=ports["a"])
        _launches(reset=True)
        t0 = time.monotonic()
        reqs = serve_distributed(rm, bc, prompts if ctrl else None,
                                 GenerationConfig(max_new_tokens=DIST_NEW) if ctrl else None)
        torch.cuda.synchronize()
        t_end = time.monotonic()
        out["a"] = dict(_dist_stats(reqs, t_end), launches=_launches(), wall_s=t_end - t0,
                        tokens=[r.output_tokens for r in reqs], guids=[r.guid for r in reqs],
                        broadcast=dict(bc.stats))
        bc.close()

        # (b) the background server under the mesh: rank 0 takes the requests
        class ServedLLM(LLM):
            """The LLM API over this rank's manager, the id tokenizer and the mesh."""

            def __init__(self):
                self.rm, self.tokenizer, self.output_file = rm, IdTokenizer(), ""
                self.mesh, self.broadcast_port = mesh, ports["b"]

        llm = ServedLLM()
        guid0 = max(rm._requests)
        _launches(reset=True)
        t0 = time.monotonic()
        llm.start_server()
        if ctrl:
            stream = llm.generate_stream(prompts[0], max_new_tokens=DIST_NEW)
            waves = {}

            def wave(name, ps):
                waves[name] = llm.generate(ps, max_new_tokens=DIST_NEW)

            first_wave = threading.Thread(target=wave, args=("first", prompts[1:4]))
            first_wave.start()
            deltas = [next(stream)]  # decoding has begun: 4 more arrive now
            t_more = time.monotonic() - t0
            second_wave = threading.Thread(target=wave, args=("second", prompts[4:]))
            second_wave.start()
            deltas += list(stream)
            first_wave.join()
            second_wave.join()
        llm.stop_server()  # a follower's returns on the controller's sentinel
        torch.cuda.synchronize()
        t_end = time.monotonic()
        served = {g: r for g, r in rm._requests.items() if g > guid0}
        out["b"] = dict(launches=_launches(), wall_s=t_end - t0,
                        requests={g: (r.prompt_tokens, r.output_tokens, r.state)
                                  for g, r in served.items()})
        if ctrl:
            by_prompt = {tuple(r.prompt_tokens): g for g, r in served.items()}
            out["b"].update(
                _dist_stats(list(served.values()), t_end), more_after_s=t_more,
                guids=[by_prompt[tuple(p)] for p in prompts],
                stream_joined="".join(deltas) == IdTokenizer().decode(
                    served[by_prompt[tuple(prompts[0])]].output_tokens),
                stream_chunks=len([d for d in deltas if d]),
                broadcast=dict(rm.broadcaster.stats))
        torch.save(out, f"{tmp}/dist.{rank}.pt")
    finally:
        if rm is not None:
            rm.close()
        dist.destroy_process_group()


def dist_phase(card: str) -> dict:
    """Multi-process serving (see the module docstring, phase dist): two
    plain subprocesses formed through ``init_distributed``, sharing the
    card over gloo; each rank is killed at ``DIST_LIMIT_S``."""
    import subprocess

    import torch

    from flexflow_tpu_torch.parallel.mesh import _free_port

    t_phase = time.perf_counter()
    if "tokens" not in _SERVED:
        _one_device_served(torch.device("cuda"), "dist one device")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dist_")
    procs = []
    try:
        with open(f"{tmp}/dist.json", "w") as f:
            json.dump({"a": _free_port(), "b": _free_port()}, f)
        coordinator = f"127.0.0.1:{_free_port()}"
        for r in range(2):
            env = dict(os.environ, FF_COORDINATOR_ADDRESS=coordinator, FF_NUM_PROCESSES="2",
                       FF_PROCESS_ID=str(r))
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--dist-rank", tmp], env=env))
        deadline = time.monotonic() + DIST_LIMIT_S
        for p in procs:
            try:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                raise PhaseError(f"dist: the ranks did not finish within {DIST_LIMIT_S} s")
        codes = [p.returncode for p in procs]
        require(codes == [0, 0], f"dist: ranks exited {codes}")
        ranks = [torch.load(f"{tmp}/dist.{r}.pt", weights_only=False) for r in range(2)]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    r0, r1 = ranks
    a, b = r0["a"], r0["b"]
    want = _SERVED["tokens"]
    require(a["tokens"] == r1["a"]["tokens"] and a["guids"] == r1["a"]["guids"],
            "dist (a): the ranks' tokens differ")
    require(all(len(t) == DIST_NEW for t in a["tokens"]), "dist (a): a request came short")
    apart = [i for i, (g, w) in enumerate(zip(a["tokens"], want)) if g[0] != w[0]]
    require(not apart, f"dist (a): first tokens of requests {apart} differ from the serve "
                       "phase's")
    a_equal = sum(x == y for g, w in zip(a["tokens"], want) for x, y in zip(g, w))
    require(b["requests"] == r1["b"]["requests"],
            "dist (b): the ranks' guids or tokens differ")
    require(all(s == "COMPLETED" and len(t) == DIST_NEW for _, t, s in b["requests"].values()),
            "dist (b): a request did not complete with its tokens")
    b_tokens = [b["requests"][g][1] for g in b["guids"]]
    apart = [i for i, (g, w) in enumerate(zip(b_tokens, a["tokens"])) if g[0] != w[0]]
    require(not apart, f"dist (b): first tokens of requests {apart} differ from (a)'s")
    require(b["stream_joined"], "dist (b): the streamed deltas do not join to the output")
    for run in (a, b):
        for k in ("qmm_int8", "decode_attention", "flash_prefill"):
            require(run["launches"][k] > 0, f"dist: {k} was never launched")
    b_same = sum(g == w for g, w in zip(b_tokens, a["tokens"]))
    prefix = _common_prefix(a["tokens"], want)
    bst = b["broadcast"]
    n_msg = max(bst["messages"], 1)
    # the tokens and prompts stay out of the summary line
    a = {k: v for k, v in a.items() if k not in ("tokens", "guids")}
    b = {k: v for k, v in b.items() if k not in ("requests", "guids")}
    out = dict(card=card, a=a, b=b, build_s=r0["build_s"], a_equal_to_serve=a_equal,
               a_prefix=prefix, b_requests_equal_to_a=b_same)
    log(f"  dist (a) serve_distributed at T=2 over gloo: both ranks' tokens equal, every first "
        f"token the serve phase's, {a_equal} of {DIST_NEW * len(want)} tokens equal to the serve "
        f"phase's (before the first difference, per request: {prefix}); decode "
        f"{a['decode_tok_s']:.1f} tok/s, mean TTFT {a['mean_ttft_ms']:.1f} ms, "
        f"{a['wall_s']:.3f} s [{card}]")
    log(f"  dist (b) start_server under the mesh: 4 requests (1 streamed, "
        f"{b['stream_chunks']} chunks), 4 more {b['more_after_s']:.3f} s in; both ranks' guids "
        f"and tokens equal, every first token (a)'s, {b_same} of {len(b_tokens)} requests equal "
        f"to (a)'s; decode {b['decode_tok_s']:.1f} tok/s, mean TTFT {b['mean_ttft_ms']:.1f} ms, "
        f"{b['wall_s']:.3f} s [{card}]")
    log(f"  dist (b) broadcast: {bst['messages']} messages (ticks and the sentinel), "
        f"{bst['bytes']} bytes, {1e3 * bst['seconds'] / n_msg:.4f} ms a message on the "
        f"controller (max {1e3 * bst['max_seconds']:.4f}) [{card}]")
    log(f"  dist: one device (serve phase) decode {_SERVED['decode_tok_s']:.1f} tok/s, mean "
        f"TTFT {_SERVED.get('mean_ttft_ms', float('nan')):.1f} ms; launches (a) "
        f"{json.dumps(a['launches'])}, (b) {json.dumps(b['launches'])}")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"  dist phase wall {out['seconds']:.1f} s, the ranks' build {r0['build_s']:.1f} s of it "
        f"[{card}]")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default=",".join(DEFAULT_PHASES),
                    help="comma-separated phases to run (default: all but profile)")
    ap.add_argument("--profile", action="store_true",
                    help="add the profile phase (traces the serve and spec phases run)")
    ap.add_argument("--reps", type=int, default=20, help="timed launches per kernel")
    ap.add_argument("--parent", metavar="DIR",
                    help="a checkout holding an earlier quant_matmul.cu, flash_prefill.cu, "
                         "decode_attention.cu and/or qmm_variants.cu: each built beside this one "
                         "and timed beside its rows; INT8 qmm held bitwise equal to it, the "
                         "attention kernels and the i8_group / i4_and_2dot variants to the same "
                         "limits as this tree's")
    ap.add_argument("--dist-rank", metavar="DIR", help=argparse.SUPPRESS)  # a dist phase rank
    args = ap.parse_args(argv)
    phases = [p for p in args.only.split(",") if p] + (["profile"] if args.profile else [])
    unknown = set(phases) - set(PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if args.dist_rank:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        _dist_rank(args.dist_rank)
        return 0
    from flexflow_tpu_torch.ops.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from flexflow_tpu_torch.benchmarks import tune_quant_kernel as tq

    card = tq.card(torch.device("cuda"))
    log(card)  # nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
    log(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    log(f"[card] host memory: MemTotal {_meminfo_gib('/proc/meminfo', 'MemTotal'):.2f} GiB, "
        f"MemAvailable {_mem_available_gib():.2f} GiB with a CUDA context")

    t_start = t0 = time.perf_counter()
    _build.lib()
    log(f"[build] kernels built and loaded in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {'cached' if _build.build_seconds is None else f'{_build.build_seconds:.1f} s'})")
    entry = ""  # the kernel (mangled, past its file's namespace) each ptxas line is about
    for line in _build.build_log.splitlines():
        if "Compiling entry function" in line:
            entry = re.sub(r"^_ZN\d+_GLOBAL__N__\w+?_cu_[0-9a-f]{8}", "", line.split("'")[1])[:80]
        elif "registers" in line or "spill" in line:
            log(f"[build]   {entry}: {line.strip()}")
        elif line.startswith("=="):
            log(f"[build]   {line.strip()}")

    parent = {}
    if args.parent:
        t0 = time.perf_counter()
        parent = build_parent(args.parent)
        log(f"[build] earlier {', '.join(f'{n}.cu' for n in parent)} from {args.parent} built "
            f"and loaded in {time.perf_counter() - t0:.1f} s")

    records: list = []
    summary: dict = {}
    held: dict = {}  # the serve phase's model, kept for the openai phase
    phase_s = {"build": time.perf_counter() - t_start}
    t0 = time.perf_counter()

    def lap(name):  # seconds since the last lap, under the phase's name
        nonlocal t0
        phase_s[name] = time.perf_counter() - t0
        log(f"[{name}] phase wall {phase_s[name]:.1f} s, {time.perf_counter() - t_start:.1f} s "
            "since the start")
        t0 = time.perf_counter()

    if "kernels" in phases:
        for bits in (8, 4):
            log(f"[kernels] qmm_int{bits}")
            qmm_phase(bits, args.reps, records, parent.get("quant_matmul"))
        log("[kernels] decode_attention")
        decode_attention_phase(args.reps, records, parent.get("decode_attention"))
        log(f"[kernels] decode_attention's shard form (C = {SHARD_DEGREES}) and merge_states")
        decode_attention_shard_phase(args.reps, records)
        log("[kernels] flash_prefill")
        flash_prefill_phase(args.reps, records, parent.get("flash_prefill"))
        lap("kernels")
    if "variants" in phases:
        log("[variants] quant-kernel tuning path: six dequant-matmul variants x "
            "column widths, qmm_int8 / qmm_int4, B=8 4096x11008 g=128")
        summary["variants"] = variants_phase(args.reps, records, parent.get("qmm_variants"))
        lap("variants")
    if "crosscheck" in phases:
        for bits in (8, 4):
            log(f"[crosscheck] 2-layer LLaMA-2-7B-width INT{bits}, GPU kernels vs CPU plain")
            summary[f"crosscheck_int{bits}"] = crosscheck_phase(bits)
        lap("crosscheck")
    if "serve" in phases:
        log("[serve] LLaMA-2-7B INT8, 8 requests, decode_horizon=16, pipelined")
        summary["serve"] = serve_phase(card, "profile" in phases,
                                       held if "openai" in phases else None)
        lap("serve")
    if "openai" in phases:
        log("[openai] the served model behind LLM.start_server() and the OpenAI endpoint on "
            "loopback: 1 sampled request, 8 client threads, 1 stream, 2 refusals")
        summary["openai"] = openai_phase(card, held)
        # the serve phase's engine (reference cycles through its manager's
        # threads): freed before later phases measure their peak memory
        held.clear()
        gc.collect()
        torch.cuda.empty_cache()
        lap("openai")
    if "spec" in phases:
        log("[spec] LLaMA-2-7B INT4 verifier + 160M-class draft, tree width 3 depth 4, "
            "8 requests, fused and pipelined; then a second draft (width 1 depth 6) beside it, "
            "rotated and merged")
        summary["spec"] = spec_phase(card, "profile" in phases)
        lap("spec")
    if "mixtral" in phases:
        log("[mixtral] Mixtral-8x7B INT8 (32 layers, 8 experts top-2), 8 requests, "
            "decode_horizon=16, pipelined; the 2-layer cross-check first; then Mixtral as the "
            "verifier of a 160M-class draft, width 3 depth 4")
        summary["mixtral"] = mixtral_phase(card, "profile" in phases)
        lap("mixtral")
    if "offload" in phases:
        log("[offload] CPU offload: (a) LLaMA-2-7B INT8 resident against offload, 8 requests x 64 "
            "tokens; (b) Mixtral-8x7B bf16, 4 layers, resident against offload, logits bitwise; "
            f"(c) Mixtral-8x7B bf16, {OFFLOAD_LAYERS} layers from pinned host memory, 8 requests "
            f"x {OFFLOAD_NEW_TOKENS} tokens")
        summary["offload"] = offload_phase(card)
        lap("offload")
    if "lora" in phases:
        log("[lora] LLaMA-2-7B INT8 with 4 LoRA adapters (rank 16, all seven projections), "
            "8 requests routed " + str(LORA_IDS) + ", decode_horizon=16, pipelined; the "
            "2-layer cross-check first")
        summary["lora"] = lora_phase(card, "profile" in phases)
        lap("lora")
    if "finetune" in phases:
        log("[finetune] LLaMA-2-7B INT8 (32 layers) with 2 LoRA slots (rank 16, wq and wv): "
            "gradients through the kernels against the plain path, then SGD finetuning of slot 1 "
            f"({FT_STEPS} steps of {FT_LEN} tokens) co-scheduled with 8 requests routed "
            f"{FT_IDS}")
        summary["finetune"] = finetune_phase(card)
        lap("finetune")
    if "train" in phases:
        log(f"[train] the Trainer at LLaMA-2-7B width, {TRAIN_LAYERS} layers, f32, Adam: "
            f"a first step against the CPU, {TRAIN_STEPS} steps of {TRAIN_BATCH} x {TRAIN_LEN} "
            "tokens, a checkpoint resume")
        summary["train"] = train_phase(card)
        lap("train")
    if "graph" in phases:
        log("[graph] the graph layer: AlexNet 3x224x224 (batch 8 against the CPU, 8 Adam steps at "
            f"batch {GRAPH_TRAIN_BATCH}), the BERT-large proxy ({BERT_CHECK_LAYERS} layers against "
            f"the CPU, {BERT_LARGE['layers']} layers x {BERT_STEPS} SGD steps at "
            f"{BERT_BATCH} x {BERT_LARGE['seq']}), a Keras CNN, the fx / IR / ONNX frontends")
        summary["graph"] = graph_phase(card)
        lap("graph")
    if "search" in phases:
        log("[search] the rewrite x placement search on one device: mlp_unify --full with and "
            "without auto_parallel, its plan over matmuls timed on the card, "
            f"Trainer(mesh='auto') at LLaMA-2-7B width ({TRAIN_LAYERS} layers, {SEARCH_BATCH} x "
            f"{SEARCH_LEN}) against the cost model, the C5 top-k on tied rows")
        summary["search"] = search_phase(card)
        lap("search")
    if "tp" in phases:
        log("[tp] tensor and data parallel serving: (a) LLaMA-2-7B INT8 through the sharded "
            "path on one rank over NCCL; two ranks sharing the card over gloo: (b) T=2, (c) D=2, "
            f"(d) the INT4 speculative pair at T=2 ({TP_SPEC_LAYERS}-layer verifier, "
            f"{TP_SPEC_NEW} tokens), "
            f"(e) Mixtral-8x7B INT8 at "
            f"{TP_MIXTRAL_LAYERS} layers, T=2; (f) NCCL across GPUs when there are several")
        summary["tp"] = tp_phase(card)
        lap("tp")
    if "meshtrain" in phases:
        log("[meshtrain] gradients and adapters over a mesh: (a) the train phase's Trainer on one "
            f"NCCL rank through the sharded path; two ranks sharing the card over gloo: (b) T=2 "
            f"and (c) D=2 Trainers at {MT_RANK_LAYERS} layer, (d) LoRA serving at T=2 "
            f"(LLaMA-2-7B INT8, {MT_LORA_LAYERS} layers, {MT_LORA_DTYPE}, 4 adapters) with (e) "
            f"co-scheduled finetuning of slot {MT_FT_SLOT}; (f) NCCL across GPUs when there "
            "are several; the layout searches over the two gloo ranks: search (e) "
            f"Trainer(mesh='auto') at {MT_RANK_LAYERS} layer, (f) mlp_unify "
            f"{' '.join(SM_UNIFY_ARGS)}, (g) LLM.compile(auto_parallel=True) at "
            f"{SM_LLM_LAYERS} layers bf16, the serve prompts x {SM_LLM_NEW} tokens")
        summary["meshtrain"] = meshtrain_phase(card)
        lap("meshtrain")
    if "layouts" in phases:
        log("[layouts] the serving layouts left under a mesh: (a) CPU offload under a mesh, "
            f"LLaMA-2-7B INT8 at {LAYOUT_OFFLOAD_LAYERS} layers on one NCCL rank and at T=2 over "
            "two gloo ranks; (b) hybrid_ffn at data=2 x model=1, INT8 and INT4 "
            f"at {LAYOUT_LAYERS} layers ({LAYOUT_HYBRID_DTYPE}), with offload once; (c) expert "
            f"parallelism at T=2, Mixtral-8x7B {' and '.join(LAYOUT_EP_DTYPES)} at "
            f"{TP_MIXTRAL_LAYERS} layers; "
            "(d) NCCL across GPUs when there are several")
        summary["layouts"] = layouts_phase(card)
        lap("layouts")
    if "pp" in phases:
        log("[pp] pipeline-parallel serving, two ranks sharing the card over gloo: (a) "
            f"LLaMA-2-7B INT8, 32 layers, P=2, M={PP_MICROBATCHES} (the overlapped horizon); (b) "
            f"INT4 at {PP_INT4_LAYERS} layers, P=2, M={PP_INT4_MICROBATCHES}, chunked prefill at "
            f"{PP_CHUNK} tokens; (d) the spec phase's INT4 pair (32 layers) through "
            f"PipelineSpecEngine, P=2, M={PP_SPEC_MICROBATCHES}; (c) NCCL across GPUs when there "
            "are several")
        summary["pp"] = pp_phase(card)
        lap("pp")
    if "pptrain" in phases:
        log(f"[pptrain] training under pipeline stages, two ranks sharing the card over gloo: (a) "
            f"the Trainer at LLaMA-2-7B width, {PT_LAYERS} layers, f32, P=2, M={PT_MICROBATCHES}, "
            f"{MT_STEPS} SGD steps on {TRAIN_BATCH} x {TRAIN_LEN} tokens; (b) pipeline_forward "
            f"over stages {list(PT_SIZES)}; (c) NCCL across GPUs when there are several")
        summary["pptrain"] = pptrain_phase(card)
        lap("pptrain")
    if "cp" in phases:
        log("[cp] context parallelism, two ranks sharing the card over gloo, the verifier's KV "
            "cache cut on its positions: (a) LLaMA-2-7B INT8, 32 layers, C=2, the serve traffic; "
            "(b) the spec phase's INT4 pair at C=2; (c) LLaMA-2-7B width at "
            f"{CP_F32_LAYERS} layers in f32, prompts {list(CP_F32_LENS)} x {CP_F32_NEW} tokens; "
            f"(d) the ring prefill at S={CP_RING['s']}, bf16; (f) LoRA + finetuning, (g) "
            "offload, (h) the Trainer at C=2; four ranks at P=2 x C=2: (i) the pipeline engine, "
            "(j) the Trainer; (e) NCCL across GPUs when there are several")
        summary["cp"] = cp_phase(card)
        lap("cp")
    if "dist" in phases:
        log("[dist] multi-process serving: two processes formed through init_distributed "
            "(FF_COORDINATOR_ADDRESS, FF_NUM_PROCESSES, FF_PROCESS_ID) sharing the card over "
            "gloo, LLaMA-2-7B INT8 at T=2: (a) serve_distributed of the 8 prompts; (b) "
            "LLM.start_server under the mesh, 4 requests then 4 more from a second thread")
        summary["dist"] = dist_phase(card)
        lap("dist")

    # each path's launches, counted from 0 over its run: the served runs for
    # the serving kernels (two drafts rotated and merged, and Mixtral as a
    # verifier, among them), the tuning run for the variants
    served = [summary.get(p, {}) for p in ("serve", "openai", "spec", "mixtral", "lora",
                                           "finetune")]
    served += [summary.get("spec", {}).get(m, {}) for m in ("rotation", "merged")]
    served.append(summary.get("mixtral", {}).get("spec", {}))
    tp = summary.get("tp", {})  # (a) in this process; (b), (c) and (d) on rank 0
    served += [tp.get("a", {}), tp.get("b", {}), tp.get("c", {}), tp.get("d", {}),
               {"launches": tp.get("d", {}).get("incremental_launches", {})}]
    served.append(summary.get("meshtrain", {}).get("d", {}))  # (d) + (e) on rank 0
    served.append(summary.get("meshtrain", {}).get("search", {}).get("g", {}))  # both ranks
    la = summary.get("layouts", {})  # (a) one NCCL rank in this process; the rest on rank 0
    served += [la.get("a_nccl", {}).get(r, {}) for r in ("resident", "offload")]
    served += [la.get("a", {}).get(r, {}) for r in ("resident", "offload")]
    lb = la.get("b", {})
    served += [lb.get("int8", {}), lb.get("int4", {}), lb.get("offload", {}),
               {"launches": lb.get("offload", {}).get("resident_launches", {})}, la.get("c", {})]
    pp = summary.get("pp", {})  # every rank's launches, each case's
    served += [pp.get("pp-a", {}), pp.get("pp-b", {}), pp.get("pp-d", {})]
    cp = summary.get("cp", {})  # every rank's launches, each case's
    served += [cp.get(k, {}) for k in ("a", "b", "c", "f", "i")]
    served += [cp.get("g", {}).get(r, {}) for r in ("resident", "offload")]
    dist_ = summary.get("dist", {})  # rank 0's launches, each run's
    served += [dist_.get("a", {}), dist_.get("b", {})]
    offload = summary.get("offload", {})
    served += [offload.get("llama", {}).get(r, {}) for r in ("resident", "offload")]
    served.append(offload.get("mixtral", {}))
    launches = {k: sum(run.get("launches", {}).get(k, 0)
                       for run in ([summary.get("variants", {})] if k in VARIANTS else served))
                for k in SOURCES}
    kernels = [
        dict(name=r["name"], route="cuda", source=SOURCES[r["kernel"]],
             replaces=REPLACES[r["kernel"]], launches=launches[r["kernel"]],
             max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
             bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=r["library_ms"],
             **({"split": r["split"]} if "split" in r else {}))
        for r in records
    ]
    summary["phase_seconds"] = phase_s
    log(f"[done] phases {','.join(phases)} in {time.perf_counter() - t_start:.1f} s, the build "
        f"included; seconds per phase {json.dumps({k: round(v, 1) for k, v in phase_s.items()})} "
        f"[{card}]")
    log(json.dumps({"summary": summary, "card": card}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
