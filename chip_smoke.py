"""Drive the PyTorch/CUDA port (eagle_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--out DIR] [--parent-report FILE]

Phases (any failed check raises and exits nonzero; nothing is caught):
1. device line: the card's name and power limit, the nvcc version; the
   kernels are built from `eagle_tpu_torch/csrc/` (one nvcc per source, in
   parallel) and ptxas' register / shared-memory report is written to DIR.
2. every kernel against its plain PyTorch version on the card, at the main
   paths' shapes: qmm for each Vicuna-7B projection through the stacked
   entry (layer 5), lm_head and the EAGLE fc through the 2-D entry, one
   Q6_K-form weight and one unpacked weight with bf16 scales and bias, at
   1, 6, 37 and 512 rows, and the GGUF path's Q4_0 (packed, f32 scale and
   bias) and Q8_0 (int8, no bias) forms at 1, 6 and 512 rows, bf16 compute
   (relative error <= 1e-2); every one of these forms also through the
   wgmma body at 9, 37, 64, 65, 128, 300 and 512 rows (and the main
   forms timed at the tree verify forwards' 29 and 32 rows, with one line
   for the qmm of each tree verify, 129 launches) and through the
   small-row mma.sync body (qmm_mma) at 2, 3, 6 and 8 rows (checks only);
   every 1-row call asserted to take the 1-row body (qmm_gemv); one line for the decode
   qmm per token (32 x 4 projections + lm_head at 1 row, with
   --parent-report also as a ratio to the parent's), one for the prefill
   qmm per prompt (the same at 512 rows) and one for the qmm of an EAGLE
   verify cycle (at 6 rows: kernel, bound, library ms), each 1-, 6- and
   512-row time as a ratio to library_ms (and, with --parent-report, to the
   kernel of the tree that wrote that report); qmm and qmm_i4 at the shapes
   only the SIMT body takes (N = 4001, N = 4100, K = 4128) at 1, 6 and 37
   rows, asserted to take it, qmm at N = 4001 timed; qmm_i4 and
   qmm_i4_stacked at the 7B projections on the small-row body (qmm_i4_mma)
   at 2, 3, 6 and 8 rows, G 32 with bf16 scale and bias and G 16 with an
   f32 scale and no bias (checks only); ffn_out_norm and gate_up_act at
   Vicuna-7B widths for 1, 2, 6, 9, 32, 33 and 64 rows (timed at 1, 6 and
   32, those times as ratios), stacked Q4_0 (layer 5) and the draft's single-layer
   Q8_0 (relative error <= 1e-2), gate_up_act at 1 row asserted to take the
   paired 1-row body and to equal silu(g) * u from qmm_stacked's sums bit
   for bit; flash_decode at S=1024,
   T in {1, 6}, 32 heads of 128 with a holed tag mask, at T = 29 under the
   static tree's ancestor mask and T = 32 under an EAGLE-2 window mask
   (the tree verify forwards), and at T=S=512 as the EAGLE engine's prompt
   takes it; flash_prefill at T=512 with padded
   and q_pos=-1 rows, one of them inside a 64-row tile (relative error <=
   1e-2), and as a chat turn's feed at an offset runs it: T = 16, 32 and
   64 rows (3 of them padding) from positions 300, 700 and 960, s_limit 512
   or 1024, at g = 1 and 4 (T = 32 from 700 at S = 1024 timed); both kernels at g = 4 (8 kv heads) for T = 6 and 20 at s_limit
   300, with a fully masked row (checks only); both kernels at head width
   256, bf16 and f32 caches, at Gemma-7B's 16 / 16, Gemma-2-9B's 16 / 8
   and Gemma-2B's 8 / 1 heads: T = 1 and 6 over S = 1,024 at s_limit 300
   and 1,024, a 512-row prompt over 300 slots, fully masked rows inside a
   tile equal to the uniform average of V; with a bf16 cache also the
   prompt in `Generator._prefill`'s layout, flash_decode over the EAGLE
   engine's 512-row prompt (also with a row masked whole inside a 64-row
   block), and phase chat's feeds at g = 1 and 2 (`[flash d256]` lines with
   the plan, flash_decode's body below 64 rows per kv head merging its key
   splits in the launch, and the key tiles that the wgmma body reads under
   rules B and M; the s_limit 1,024 calls, the prompts
   and the feeds timed, SDPA with `enable_gqa`; with --parent-report every
   timed flash row also beside the parent's time). Each prints kernel ms, plain
   ms, the bound (bytes over 3.35 TB/s or operations over 989 TFLOP/s bf16,
   whichever is larger) and library_ms (one PyTorch call computing the
   same function, or for the fused FFN kernels the same product: torch.matmul
   on a pre-dequantized bf16 weight, or scaled_dot_product_attention with
   the bool mask — timed here only, the port never calls it). Times are per
   call of a CUDA-graph replay timed with CUDA events
   (`eagle_tpu_torch/timing.py:device_ms`), so the host's launch overhead
   does not count. A tiny 2-layer model's logits on the card are also held against
   the CPU plain path (relative error <= 1e-3, f32); its forward's launch
   counts (every f32 product on the SIMT qmm body) are the SIMT row's.
3. greedy decoding at full width: VICUNA_7B (32 layers, 4096 wide, 11008
   FFN, 32000 vocab), Q4_K packed coded weights synthesized on the card,
   bf16 KV cache, max_seq 1024; a 300-token prompt (bucket 512, prefill
   kernel), then 64 decoded tokens; EAGLE_TPU_FUSED_FFN unset.
4. the EAGLE chain engine at full width with a full-width synthetic draft,
   K = 5, 64 new tokens. Phases 3-4 run `serve_cell`: greedy and EAGLE,
   each eager (`cuda_graphs=False`) and graphed (one CUDA graph replay per
   decode step and per dispatch of EAGLE cycles, `runtime/graphs.py`), EAGLE
   graphed at 1 and 4 cycles per dispatch; the graphed engines are warmed
   first (their graphs captured at the runs' buckets), then every graphed
   variant is timed twice (min / median / max of tokens/s, TTFT and wall
   ms per token or cycle: the host's spread) and every eager one once.
   Graphed tokens must equal eager
   tokens bit for bit, greedy and EAGLE alike, and no step or cycle of a
   graphed engine may run eagerly after the warm-up. EAGLE's tokens are
   compared with greedy's, and where they differ the target's top-2 logit
   margin there must be within 1e-2 of the logit range (a bf16 near-tie,
   not a divergence). The graphed step's and cycle's device ms come from
   CUDA events around back-to-back replays, beside the wall ms and the idle
   share; the eager step is traced with torch.profiler (device busy share,
   kernels per token, the kernels that take the time).
5. the launch counts, read from zero for every run, replays counted as
   launches: per greedily decoded token exactly 129 qmm_gemv (qmm's 1-row
   body) and no SIMT qmm, eager and graphed; per EAGLE cycle computed
   exactly 129 qmm_mma (its small-row body); qmm_tc (its wgmma body)
   exactly 129 for the greedy prompt, and more for the EAGLE prompt, whose
   draft also runs at 512 rows; qmm_mma 0 for greedy; the draft's 1-row
   products printed; qmm_gemv, qmm_tc, qmm_mma, flash_decode and
   flash_prefill each > 0 over the default path (graphed greedy + graphed
   EAGLE at 1 cycle per dispatch, counted together: the main path of the
   `kernels` line), the fused FFN kernels 0, the plain versions 0.
tree. the tree engines on phase 3's model after the same prompt:
   EagleTreeEngine at the reference's default TreeSpec((4, 2, 2)) (29
   verify rows; draft levels of 1, 4 and 8 rows) eager and graphed, and
   EagleTree2Engine at its defaults (beam 8, depth 6, 32 verify rows) eager
   and graphed at 1 and 4 cycles per dispatch, 64 new tokens, 2 timed runs
   of each graphed variant and 1 of each eager one (`[q4_k tree]` lines:
   tokens/s, TTFT, wall ms per cycle, mean_accept_len; graphed: device ms
   per cycle from CUDA events over 8 replayed cycles, idle share). Every
   run's launches per computed cycle must equal what `tree_cycle_launches`
   derives from the code (129
   qmm_tc per verify, the draft's qmm_gemv and qmm_mma, flash_decode),
   graphed tokens must equal eager tokens bit for bit, no cycle may run
   eagerly after the warm-up, and the tokens equal greedy's up to a bf16
   near-tie. Then each engine graphed with an oracle draft (its logits
   boosted at the greedy continuation, read from a device tensor): tokens
   equal greedy's and every cycle accepts the full depth; its tokens/s is
   an upper bound. The tree path's launch counts (each engine's graphed
   C = 1 run, from zero) stand in the `kernels` line as
   `tree_path_launches`.
6. the GGUF path at full width and depth: a Vicuna-7B-shape Q4_0 GGUF
   (3.8 GB, laid out as llama-quantize's Q4_0) and an EAGLE Q8_0 draft
   (0.39 GB) minted with random blocks into a temporary directory (free
   space logged; the target carries an SPM vocabulary of 32,000 pieces,
   `spm_vocab`; the files stay for phase cli), loaded with the repack on
   the card (read / upload / repack times, device memory), five tensors
   checked bit for bit against the CPU repack of the same bytes, then
   `serve_cell` with EAGLE_TPU_FUSED_FFN=1 and again unfused (per greedily
   decoded token 65 qmm_gemv, 32 ffn_out_norm and 32 gate_up_act fused,
   129 qmm_gemv unfused; qmm_mma 65 per cycle fused and 129 unfused; fused
   kernels > 0 only when on; plain versions 0), whether the fused block
   pays under graphs (graphed device ms per token and median tokens/s,
   fused against unfused), and fused = unfused greedy tokens up to the
   near-tie rule; then EagleTree2Engine graphed at C = 1 on each (2 runs;
   fused: 32 of each fused kernel per verify, plus the draft's), its
   tokens fused against unfused under the same rule.
cli. the normal entry point on phase 6's files (unfused): three runs of
   `python -m eagle_tpu_torch.tools.cli -m target --draft draft -p PROMPT
   -n 64` as subprocesses, two at a time (PROMPT: ~300 tokens of the
   vocabulary's words), at the defaults (temp 0.8, top-k 40, top-p 0.95,
   min-p 0.05, seed 0) twice and with --temp 0; each must exit 0 and print
   its text and its `[speculative]` line, the two default runs the same
   text. Then one `Engine` from the files (the chain at the CLI's defaults,
   max_seq 2048, graphed) and from its loaded params `Generator`, the chain
   at C = 1 and 4, the static tree (4, 2, 2) and EAGLE-2 (8, 6, 32), all
   sampled at the defaults from seed 0: eager once, graphed once to
   capture and 2 timed graphed runs (`[cli sampled]` lines: tokens/s, TTFT,
   wall and device ms per token or cycle, idle share, accept_rate and
   mean_accept_len), every run's tokens equal bit for bit, no eager body
   after the capture, launches per token or cycle as the greedy cells'
   (129 qmm_gemv per token, 129 qmm_mma per chain verify,
   `tree_cycle_launches` per tree cycle). On these random weights the
   defaults leave one token per step, so each engine runs again under a
   flat chain (top-k 40, temperature a quarter of the prompt's top-1 to
   top-40 logit gap): eager == graphed bit for bit, seed 1 another stream
   (`[cli flat]` lines). At temp 0 each speculative engine's tokens equal
   the greedy Generator's up to a bf16 near-tie, and the in-process greedy
   chain's text the CLI's --temp 0 text; the sampler's share of the device
   time is each sampled cell's device ms less phase 6's greedy cell's
   (`sampler_share`).
chat. a conversation over the live cache on phase 6's files (unfused,
   greedy, the vicuna template): `python -m eagle_tpu_torch.tools.cli
   --chat --chat-template vicuna --temp 0 -n 48` as a subprocess with three
   user turns (~120, 60 and 200 words of the vocabulary) on stdin; then
   in process `Engine.chat_session()` on the same turns: graphed once to
   capture, 3 timed graphed runs and one eager session (`cuda_graphs=
   False`), all the same tokens bit for bit, the CLI's output the session's
   stream; each feed (`Generator._extend` at the cache's position) exactly
   129 qmm_tc and 32 flash_prefill launches; per turn the feed's host ms
   (to the first token), its device ms (CUDA events) and decode tokens/s
   (`[chat]` lines); each turn's tokens against one graphed
   `Generator.generate` over the conversation so far, up to a bf16
   near-tie. A session on a 512-slot cache whose third turn shifts the
   context: graphed twice and eager once, bit for bit, the second graphed
   run capturing no graph (`[chat shift]`: the shift's device ms). The
   server (`-np 1`, in process on the loaded engine): /v1/embeddings and
   /rerank once each (`[chat server]`); qmm at a feed's 16, 32 and 64 rows
   (`[chat kernel]`); `Engine.embed` and `rerank` on a 2-layer model of
   phase 2's widths, f32, on the card against the CPU (relative error <=
   1e-3). The launch counts of the first timed session, from zero, stand in
   the `kernels` line as `chat_path_launches`.
serve. continuous batching on phase 6's files (unfused, K = 5, greedy):
   `Engine(batch=4, max_seq=2048)` and its `ContinuousBatcher`; prompts of
   ~40, 150, 300 and 700 tokens (two submitted, three steps, the other two;
   64 new tokens each) must give the graphed single-sequence chain's
   tokens up to the near-tie rule, a second graphed run the same tokens
   with no eager body, the eager batched run the same tokens bit for bit.
   Then 1, 2 and 4 concurrent requests of the 300-token prompt, 2 timed
   runs each (`[serve]` lines: aggregate tokens/s, TTFT per request, the
   host's ms per step, the idle share against the device ms of a batched
   cycle at B = 4 from CUDA events over 8 replays); launches per batched
   cycle asserted (129 qmm_tc for the 24-row verify, 30 qmm_mma for five
   4-row draft steps, 37 flash_decode); a spec_k = 1 slot beside two
   spec_k = 5 slots under an oracle draft (at most 1 and exactly 5 drafts
   accepted per cycle, greedy tokens); qmm at the serving shapes (24, 4 and
   64 rows) and flash_decode at B = 4, T = 6 on the served weights
   (`[serve kernel]` lines: kernel, plain, bound, library ms). Last, the
   engine freed, `python -m eagle_tpu_torch.server.server -np 4` as a
   subprocess: four concurrent /completion requests and one streamed chat
   must equal the in-process batcher's texts, /metrics count 5 requests,
   and SIGTERM end it with exit 0 and no traceback (`[serve http]`).
paged. paged and int8 serving on phase 6's files (unfused, K = 5, greedy):
   `Engine(batch=4, max_seq=2048, paged=True, page_size=64, kv_pages=64)`,
   64 pages of 64 rows against 4 x 2,048 addressable slots. (a) 1, 2 and 4
   streams of phase serve's 301-token prompt, the prefix cache off, 2 timed
   runs each (`[paged]` lines: aggregate tokens/s, TTFT, host ms per step,
   idle share, pool pages in use; the batched cycle's device ms): a slot
   against phase serve's dense batcher up to the near-tie rule, graphed ==
   eager bit for bit, no graph captured after the warm-up although the page
   tables change, 129 qmm_tc per batched verify and 134 per 64-row chunk
   (the target's 129 and the draft's 5), no flash kernel (the paged read is
   the plain one, as the reference's); (b) 4 requests sharing a 256-token
   prefix, the cache on against off: 3 hits, 768 tokens skipped, TTFT per
   request, the same tokens up to the near-tie rule (`[paged prefix]`);
   (c) the pool at int8 and the dense chain engine and `Generator` at
   int8: graphed == eager bit for bit, the first divergence from bf16,
   device ms per batched cycle, chain cycle and decode step against bf16
   (`[paged int8]`); (d) a slot saved mid-stream, restored into a fresh
   paged batcher (bit for bit) and a dense one (near-tie rule), resumed; a
   prompt-cache session's TTFT without and with the file (`[paged slot]`);
   (e) Self-Extend (grp_attn_n 4, grp_attn_w 512) on a 900-token prompt at
   max_seq 1024: graphed == eager, the shift's device ms (`[paged
   self-extend]`); (f) the CLI with --prompt-cache twice, and the server
   with `--paged --kv-pages 64 -np 4` as subprocesses: a streamed
   /completion whose slot is saved mid-stream, a /completion, the slot
   restored, SIGTERM exit 0 (`[paged cli]`, `[paged http]`).
constrained. stateful samplers and grammar-constrained decoding on phase
   6's files (unfused, K = 5), one `Engine` (the chain, greedy, max_seq
   2048) and its `Generator`, a ~100-word prompt: (a) the penalties
   (repeat, frequency, presence), DRY, mirostat v1 and v2 through the
   graphed decode step, 32 tokens: eager once and graphed twice, the same
   tokens bit for bit, no capture or eager body on the second run, 129
   qmm_gemv per token; device ms per token (CUDA events over 16 replays)
   against the same engine's greedy step and phase cli's sampled one
   (`[constrained stateful]`); (b) two chat turns with a repeat penalty,
   graphed twice and eager, bit for bit (`[constrained chat]`); (c) a
   letter grammar (`[a-h ]+`, 24 tokens) and a JSON schema (a boolean and
   an enum, 48 tokens) through `Generator.generate_constrained` (graphed
   twice, eager once for the letters) and `EagleChainEngine.generate_constrained`
   (graphed twice): the grammar accepts each text, the schema's parses
   where it closed, the chain's tokens equal the plain ones up to the
   near-tie rule among the legal tokens, 129 qmm_mma and 30 qmm_gemv per
   proposal; host ms per token of the mask walk, wall ms per token,
   device ms per constrained step and per proposal, mean_accept_len
   (`[constrained]`); (d) the engine freed, the CLI with `--draft
   --grammar` and with `--repeat-penalty 1.3 --temp 0` (each text == the
   in-process run's) and the server (`-np 1`: a `json_schema` completion
   that parses, a `tools` request with `tool_choice: "required"` that
   answers `tool_calls`; SIGTERM exit 0) as subprocesses started together
   (`[constrained cli]`, `[constrained http]`). The chain's launches of the
   timed letter-grammar run stand in the `kernels` line as
   `constrained_path_launches`.
runtime. model-free speculation, YaRN and fill-in-the-middle: (a) on phase
   6's target (unfused, max_seq 2048, a 301-token prompt: 100 words three
   times), `Engine(lookahead=(8, 4, 8))` and a `LookupEngine(n_draft=8)`,
   each eager and graphed, 2 timed runs each, 64 tokens: graphed == eager
   bit for bit, tokens == the graphed greedy `Generator`'s up to the
   near-tie rule, 129 qmm_tc and 32 flash_decode per lookahead step (48
   rows) and per lookup cycle (9 rows), t/s, TTFT, device ms per step by
   CUDA events over 8 replays, idle share (`[runtime lookahead]`,
   `[runtime lookup]`); an oracle lookup (its n-gram cache fed the greedy
   continuation, prompt lookup off); qmm at 9 and 48 rows and flash_decode
   at T = 48 under a lookahead mask against their plain versions, timed
   (`[runtime kernel]`); (b) a minted Yarn-Llama-2-7b-64k-shape GGUF (YaRN
   factor 16 over 4,096): the blend against its formula, greedy at max_seq
   8,192 on a 5,000-token prompt eager and graphed (TTFT, t/s, device ms
   per token; 129 qmm_tc and 32 flash_prefill at 8,192 rows), a context
   shift against a recompute, flash_decode over 5,064 slots and
   flash_prefill at T = 8,192 timed (`[runtime yarn]`); (c) a minted
   CodeLlama-7b-shape GGUF (32,016 pieces, the FIM control pieces):
   `Engine.infill` greedy in PSM and SPM order, eager and graphed, wall
   and filter ms per token, then the server's /infill as a subprocess
   (== the in-process text) and a phase-6 server's 400 (`[runtime
   infill]`). Each minted file is deleted after its checks. The launches
   of a graphed lookahead and lookup run, the YaRN run and the PSM infill
   stand in the `kernels` line as `runtime_path_launches`.
llama3. the Llama-3 family, after phase 6's files are gone: a minted
   Meta-Llama-3.1-8B-Instruct-shape target (d 4,096, 16 of its 32 layers, 32 heads
   over 8 KV heads, n_ff 14,336, Q4_K layers and token_embd, Q6_K output,
   rope base 500,000 with `rope_freqs.weight` by the llama3 rule at factor
   8, context 131,072, a 128,256-piece byte-level BPE vocabulary with
   consistent merges and Llama-3.1's specials, pre "llama-bpe", a llama3
   template) and an EAGLE-LLaMA3-Instruct-8B-shape Q8_0 draft, loaded
   through `api.Engine`; qmm on each route at the path's new shapes (wqkv N
   6,144, w_gate_up N 28,672, w_down K 14,336, lm_head N 128,256, the
   draft's fc K 8,192) at 1, 6 and 300 rows, the fused FFN kernels at n_ff
   14,336 on the draft's layer at 1 and 6 rows, flash_decode (T 1, 6) and
   flash_prefill (T 512) at g = 4, each against its plain version and
   timed (`[llama3 kernel]`); `serve_cell` on a ~300-token prompt of BPE
   text with multi-byte characters (`[llama3]`: 65 qmm_gemv per decoded
   token, 65 qmm_mma per verify cycle); the CLI (`--draft --temp 0`) and
   the server's /v1/chat/completions as subprocesses, each == the
   in-process Engine's text; a 512-slot `ChatSession` whose third turn
   shifts, the moved keys held against their rotation by the factored
   frequencies; then a minted Llama-3.2-3B-Instruct-shape file with a tied
   Q6_K head at 14 of its 28 layers (`[llama3 tied]`: greedy eager == graphed, 56 qmm_gemv per
   token, the "nk" head's device ms). Each minted file is deleted after its
   checks; the 8B default path's and the tied run's launches stand in the
   `kernels` line as `llama3_path_launches`.
families. the Qwen2, Qwen3, Gemma-2 and Gemma families at their published shapes,
   in a temporary directory of their own, one model at a time (minted with
   random Q4_K blocks and a Q6_K head, loaded through `api.Engine`, its
   file deleted, its kernels checked, run, freed): (a) Qwen2.5-7B-Instruct
   (d 3,584, 14 of its 28 layers, 28 query over 4 KV heads of 128: g = 7, n_ff
   18,944, q/k/v biases, rope base 1e6, a 152,064-entry byte-level BPE
   vocabulary with the "qwen2" pre-tokenizer and a chatml template) and an
   EAGLE-Qwen2-7B-Instruct-shape Q8_0 draft: qmm at every product's shape
   at 1, 6 and 300 rows (and the draft's fc), flash_decode at T = 1 and 6
   (T·g 7 and 42) and flash_prefill at T = 512 (T·g 3,584) at g = 7, each
   against its plain version with its bound and library ms (`[families
   kernel]`); `serve_cell` on a ~300-token prompt (`[qwen2.5]`: 57
   qmm_gemv and 14 flash_decode per decoded token, 57 qmm_mma per verify,
   EAGLE == greedy under the near-tie rule); (b) Qwen3-8B (12 of its 36
   layers, 32 over 8 KV heads of 128, per-head q/k norms, 151,936
   entries): qmm at 1 and 300 rows, then greedy eager once and graphed 2
   times, bit for bit (`[qwen3]`: 49 qmm_gemv and 12 flash_decode per
   token); (c) Gemma-2-9B (14 of its 42 layers, 16 over 8 KV heads of 256,
   n_ff 14,336, sandwich norms,
   GELU, softcaps 50 / 30, a 4,096-slot window on even layers,
   query_pre_attn_scalar 256, a tied Q6_K table of 256,000 SPM pieces, a
   gemma template): qmm at 1 and 300 rows, the plain softcapped attention
   (no kernel in either package) and the tied "nk" head timed, then greedy
   as (b) (`[gemma2]`: 56 qmm_gemv per token, no flash kernel); (d)
   Gemma-7B (google/gemma-7b: d 3,072, 14 of its 28 layers, 16 / 16 heads of 256, a
   4,096-wide query, n_ff 24,576, GELU, the sqrt(n_embd) embedding scale,
   no softcap or window, a tied Q6_K table of 256,000 SPM pieces, a gemma
   template) and an EAGLE Q8_0 draft at its widths: qmm at 1, 6 and 300
   rows and the draft's fc, the tied head timed, `serve_cell` (`[gemma]`:
   56 qmm_gemv and 14 flash_decode per decoded token, 56 qmm_mma per
   verify, 14 flash_prefill per greedy prompt, EAGLE == greedy under the
   near-tie rule). The launches of the Qwen2.5 and Gemma-7B default paths
   and of the other two's first timed graphed runs stand in the `kernels`
   line as `families_path_launches`; the flash rows also carry
   `head_dim_256` (phase 2's Gemma-7B bf16 times, flash_prefill's in
   `Generator._prefill`'s layout on the wgmma body; the gemma cell's
   launches).
layernorm. the rotary LayerNorm families at their published shapes, in a
   temporary directory of their own, minted as phase families mints (Q4_K
   layers, a Q6_K head, random blocks, llama.cpp's tensors of the arch:
   norm biases, q/k/v biases, attn_output.bias, ffn_up / ffn_down biases,
   no ffn_gate, output.bias): (a) StarCoder2-7B (bigcode/starcoder2-7b: d
   4,608, 16 of its 32 layers, 36 query over 4 KV heads of 128: g = 9, n_ff 18,432,
   LayerNorm eps 1e-5 with biases, a no-gate tanh-GELU MLP, rope base 1e6,
   a 49,152-entry BPE vocabulary, pre "starcoder") and an EAGLE Q8_0 draft
   at its widths: qmm at every product's shape at 1, 6 and 300 rows (and
   the draft's fc), flash_decode at T = 1 and 6 and flash_prefill at T =
   512 at g = 9, each against its plain version with its bound and library
   ms (`[layernorm kernel]`); `serve_cell` on a ~300-token prompt
   (`[starcoder2]`: 65 qmm_gemv and 16 flash_decode per decoded token, 65
   qmm_mma per verify, 16 flash_prefill per greedy prompt, EAGLE == greedy
   under the near-tie rule); (b) Phi-2 (microsoft/phi-2: d 2,560, 16 of
   its 32 layers, 32 heads of 80, 32 of 80 features rotary, one shared LayerNorm
   feeding attention and the FFN in parallel, biases on q/k/v, dense, fc1 /
   fc2 and the head, a 51,200-entry BPE vocabulary, pre "phi-2"): qmm at 1
   and 300 rows, the plain attention at D = 80 timed beside SDPA, greedy
   eager once and graphed 2 times, bit for bit (`[phi2]`: 65 qmm_gemv per
   token, no flash kernel), then the CLI (`--temp 0`) and the server's
   /v1/chat/completions as subprocesses, each == the in-process Engine's
   text (`[phi2 cli]`, `[phi2 http]`). The StarCoder2 default path's and
   the Phi-2 run's launches stand in the `kernels` line as
   `layernorm_path_launches`.
positions. the position families at their published shapes, cut in depth,
   in a temporary directory of their own, minted as phase layernorm mints
   (a fused attn_qkv, no ffn_gate, LayerNorm eps 1e-5): (a) StarCoder-15B
   (bigcode/starcoder: d 6,144, 10 of its 40 layers, 48 query heads over
   one KV head of 128: g = 48, n_inner 24,576, learned positions [8,192 x
   6,144] F32, biases on the norms, attn_qkv, attn_output, the MLP and the
   final norm, a Q6_K output.weight, a 49,152-entry BPE vocabulary, pre
   "starcoder") and an EAGLE Q8_0 draft at its widths: qmm at 1, 6 and 300
   rows (and the draft's fc), flash_decode at T = 1, 6 and 512 (the EAGLE
   prompt) and flash_prefill at T = 512 at g = 48, each against its plain
   version with its bound and library ms (`[positions kernel]`), the CPU
   port's first 3 greedy tokens on a copy of the weights (computed in a
   thread beside those checks) against the card's, then `serve_cell`
   (`[starcoder]`: 41 qmm_gemv and 10 flash_decode per decoded token, 41
   qmm_mma per verify, 10 flash_prefill per greedy prompt); (b) MPT-7B
   (mosaicml/mpt-7b: d 4,096, 8 of its 32 layers, 32 heads of 128, ALiBi
   at a maximum bias of 8, no bias anywhere, expansion 4, a tied Q6_K
   table of 50,432 rows, pre "mpt") and an EAGLE Q8_0 draft: qmm as (a),
   the plain ALiBi read at T = 1, 6 and 512 beside SDPA given the bias as
   a float mask, the tied head timed, the CPU check, `serve_cell`
   (`[mpt]`: 32 qmm_gemv per decoded token and no flash kernel on the
   target; the draft's attention is flash_decode). Both default paths'
   launches stand in the `kernels` line as `positions_path_launches`; the
   flash rows carry the g = 48 checks as `g48`.
lnfamilies. the other LayerNorm families at their published shapes, in a
   temporary directory of their own, minted as phase positions mints
   (`LNF_MINT`: each arch's tensors as llama.cpp's tables name them): (a)
   Falcon-7B (tiiuae/falcon-7b: d 4,544, 8 of its 32 layers, 71 query heads
   over one KV head of 64: g = 71, FFN 18,176, one shared LayerNorm with its
   bias feeding attention and a no-bias GELU MLP in parallel, a fused
   attn_qkv, laid out as llama-quantize's Q4_K_M falls back at K = 4,544:
   Q5_0 attn_qkv / attn_output / ffn_up / token_embd, a Q4_K ffn_down, a
   Q8_0 output.weight; a 65,024-entry BPE vocabulary, pre "falcon") and an
   EAGLE Q8_0 draft at its widths: qmm at 1, 6 and 300 rows (and the draft's
   fc), flash_decode at T = 1, 6 and 512 (the EAGLE prompt: 36,352 rows)
   and flash_prefill at T = 512 at g = 71 and D = 64, each against its
   plain version with its bound and library ms (`[lnfamilies kernel]`), the
   CPU port's first 2 greedy tokens on a copy of the weights against the
   card's, then `serve_cell` (`[falcon]`: 33 qmm_gemv and 8 flash_decode
   per decoded token, 33 qmm_mma per verify, 8 flash_prefill per greedy
   prompt); (b) Minitron-8B (nvidia/Minitron-8B-Base, nemotron: d 4,096, 8
   of its 32 layers, 48 query heads over 8 KV heads of 128, a 6,144-wide
   query, FFN 16,384 with a squared ReLU, 64 of 128 features rotary,
   LayerNorms with biases, Q4_K layers, a Q6_K head of 256,000 rows, an SPM
   vocabulary of 256,000 pieces): qmm at 1 and 300 rows, both flash kernels
   at g = 6, the CPU check, `greedy_cell` (`[minitron]`: 33 qmm_gemv, the
   head one of them, and 8 flash_decode per token); (c) 2-layer checks at
   the published widths of OLMo-1.7-7B (no norm tensor, q/k/v clamped at
   8), Orion-14B (SPM), CodeShell-7B (GQA 32 / 8, pre "codeshell") and
   GPT-J-6B (16 heads of 256, 64 rotary, an lm_head bias; its flash
   kernels timed at D = 256), each through `Engine`: 8 greedy tokens eager
   and graphed twice, bit for bit, flash_decode, flash_prefill and
   qmm_gemv launched, the CPU port's first 2 greedy tokens == the card's.
   The Falcon default path's, the Minitron run's and the checks' launches
   stand in the `kernels` line as `lnfamilies_path_launches`; the flash
   rows carry the cells' checks as `lnfamilies`.
moe. the mixture-of-experts families at their published widths, in a
   temporary directory of their own, minted as phase lnfamilies mints (an
   F32 router, the experts' [E, F, d] / [E, d, F] stacks and the shared
   expert as llama.cpp names them): (a) Mixtral-8x7B (mistralai/
   Mixtral-8x7B-v0.1: d 4,096, 4 of its 32 layers, 32 query heads over 8
   KV heads of 128, 8 experts of 14,336, 2 a token, Q4_K attention and
   experts, a Q6_K head, an SPM vocabulary of 32,000 pieces; written as
   `llama` with `llama.expert_count`) and an EAGLE Q8_0 draft at its widths
   (one dense layer, FFN 14,336); (b) Qwen1.5-MoE-A2.7B (Qwen/
   Qwen1.5-MoE-A2.7B: d 2,048, 8 of its 24 layers, 16 / 16 heads of 128,
   60 experts of 1,408, 4 a token, a shared expert of 5,632 under its
   sigmoid gate, q/k/v biases, Q4_K with the experts' down products Q5_0
   (K = 1,408), a Q6_K head, a 151,936-entry BPE vocabulary, pre "qwen2").
   Each through `Engine`: the experts read densely on the card into bf16
   stacks (one expert of each of two stacks held bit for bit against the
   CPU's decode of the file's bytes), the load's seconds and the card's
   peak memory; qmm at the path's shapes (1, 6 and 300 rows; the draft's
   fc), flash_decode and flash_prefill at g = 4 and g = 1 against their
   plain versions with bound and library ms (`[moe kernel]`); the MoE FFN
   (`models/llama.py:_moe_ffn`: every expert a dense cuBLAS product) at 1,
   6 and 300 rows against its f32 version (rel err <= 1e-2), timed as a
   CUDA graph beside its byte bound; the CPU port's first 2 greedy tokens
   on a copy of the weights against the card's (the host's resident memory
   before and after); then `serve_cell` on Mixtral (`[mixtral]`: 9
   qmm_gemv and 4 flash_decode per decoded token, 9 qmm_mma per verify)
   and `greedy_cell` on Qwen1.5-MoE (`[qwen1.5-moe]`: 17 qmm_gemv and 8
   flash_decode per token). The Mixtral default path's and the Qwen run's
   launches stand in the `kernels` line as `moe_path_launches`; the flash
   rows carry the cells' checks as `moe`.
7. the kernel benchmark (`python -m eagle_tpu_torch.tools.kernel_bench`) at
   its defaults (K 4096, N 11008, 8 rows, G 32) with every ported variant:
   each variant held against its plain version (relative error <= 1e-2),
   then timed with the launch counts read over that run (qmm_mma and
   qmm_i4_mma > 0, plain versions 0), and again with the int4 variants at 1
   row (qmm_i4 > 0) and at 512 rows (qmm_i4_tc > 0); before it, qmm_i4 and
   qmm_i4_stacked against qmm_i4_plain at the benchmark's shape (1 and 8
   rows) and at the 7B projections (12288 x 4096, 4096 x 11008) for 1 (SIMT
   body), 2, 3, 6, 8 (small-row body), 37 and 512 rows (wgmma body), with
   kernel ms, plain ms, the bound and library_ms (torch.matmul on the
   pre-dequantized bf16 weight), and at 2-8 rows the SIMT body's time
   beside (the route of those rows before the small-row body took them).
8. the other GGUF formats (Q4_1, Q5_0, Q5_1, Q8_1, Q2_K, Q3_K, Q5_K, IQ4_NL,
   IQ4_XS, IQ2_XXS, IQ2_XS, IQ2_S, IQ3_XXS, IQ3_S, IQ1_S, IQ1_M): one
   [11008 x 4096] tensor of random blocks each, written with the port's
   writer, repacked on the card and held bit for bit against the CPU's
   repack of the same bytes, prepared for serving and run through qmm
   against its plain version at 1, 6 and 512 rows (Q5_K also coded; IQ1_M
   at G = 8). Last, the `kernels` JSON line (the fused kernels' launches come
   from phase 6's fused run, qmm_i4's, qmm_i4_mma's and qmm_i4_tc's from
   phase 7's kernel_bench runs (no model path makes int4 weights; the main
   path's count of qmm_i4_mma, 0, stands beside it), the SIMT qmm's from
   phase 2's f32 model; qmm_gemv's row is the decode qmm
   per token, qmm's the SIMT body at N = 4001, 1 row, qmm_tc's the prefill
   body at wqkv, 512 rows, qmm_mma's the verify body at wqkv, 6 rows) and
   the device JSON line.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import tempfile
import time
import warnings

from eagle_tpu_torch.timing import device_ms, device_us

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
TC_CHECK_ROWS = (9, 37, 64, 65, 128, 300, 512)  # both row tiles and their ragged edges
MMA_CHECK_ROWS = (2, 3, 6, 8)  # qmm's small-row tensor-core route (qmm_mma)
FFN_CHECK_ROWS = (1, 2, 6, 9, 32, 33, 64)  # the fused kernels' 1-row and small-row bodies
VERIFY_ROWS = 6  # the EAGLE chain's verify forward: K + 1 rows at K = 5
TREE_SPEC = (4, 2, 2)  # the reference's default TreeSpec: 29 verify rows
TREE2 = dict(beam=8, depth=6, n_verify=32)  # the reference's EagleTree2Engine defaults
TREE_ROWS = (29, 32)  # the tree engines' verify forwards
#: kernel rows of a report of the same script from another tree (--parent-report), by
#: (kernel, name, rows): ratios to them are printed beside this run's times
PARENT: dict = {}
BF16_FLOPS = 989e12  # dense tensor-core bf16
QMM_TOL = 1e-2
ATTN_TOL = 1e-2
TINY_TOL = 1e-3


def log(*a):
    print(*a, flush=True)


def rel_err(got, want) -> tuple[float, float]:
    """(max abs error, max abs error / max |want|)."""
    d = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    return d, d / max(scale, 1e-30)


def load_parent(path: str | None) -> None:
    if not path:
        return
    rep = json.loads(pathlib.Path(path).read_text())
    for kernel in ("qmm", "qmm_i4"):
        for r in rep.get(kernel, []):
            PARENT[(kernel, r["name"], r["rows"])] = r["ms"]
    for r in rep.get("ffn", []):
        PARENT[("ffn", f"{r['name']}/{r['form']}", r["rows"])] = r["ms"]
    tok = rep.get("qmm_per_decoded_token")
    if tok:
        PARENT[("qmm_token", "per_token", 1)] = tok["ms"]
    for r in rep.get("attention", []) + rep.get("attention_d256", []):
        if "ms" in r:
            PARENT[("flash", flash_label(r), 0)] = r["ms"]


def flash_label(r: dict) -> str:
    """A timed flash row's name across trees' reports ("attention" at
    head width 128, "attention_d256")."""
    parts = [r["name"], r.get("model", ""), r.get("dtype", ""), r.get("case", ""),
             r.get("mask", r.get("what", "")), f"T={r['t']}", f"q0={r['q0']}" if "q0" in r else "",
             f"S={r['s']}"]
    return " ".join(p for p in parts if p)


def vs_parent(r: dict) -> str:
    """", parent X ms = Yx this" for a timed flash row, with --parent-report."""
    parent = PARENT.get(("flash", flash_label(r), 0))
    return f", parent {parent:.4f} ms = {parent / r['ms']:.2f}x this" if parent else ""


def log_ratios(kernel: str, res: dict) -> None:
    """One line: this run's time against library_ms and, with a parent
    report, against the parent's kernel at the same shape."""
    parent = PARENT.get((kernel, res["name"], res["rows"]))
    vs = f", parent {parent:.4f} ms = {parent / res['ms']:.2f}x this" if parent else ""
    log(f"[ratio] {kernel} {res['name']} rows={res['rows']}: {res['ms']:.4f} ms = "
        f"{res['ms'] / res['library_ms']:.2f}x library ({res['library_ms']:.4f} ms){vs}")


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    tb, to = n_bytes / HBM_BYTES_PER_S, n_ops / BF16_FLOPS
    return (max(tb, to) * 1e3, "bytes" if tb >= to else "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def decode_bound(q, k_cache, mask) -> tuple[float, str]:
    """bound_ms of one flash_decode call on this run's data: K and V of the
    slots that some query row sees, each read once, the mask [B, T, lim], q
    read and the f32 output written; two matmuls over the visible (query,
    key) pairs."""
    b, t, h, d = q.shape
    slots, pairs = int(mask.any(dim=1).sum()), int(mask.sum())
    kv_bytes = 2 * slots * k_cache.shape[2] * d * k_cache.element_size()
    return bound_ms(kv_bytes + nbytes(q, mask) + q.numel() * 4, 4.0 * pairs * h * d)


def prefill_bound(q, k_cache, q_pos, tags, lim: int) -> tuple[float, str]:
    """bound_ms of one flash_prefill call on this run's data: K and V of the
    slots that some query row sees, each read once, the tags of [0, lim), q
    and q_pos read and the f32 output written; two matmuls over the visible
    (query, key) pairs."""
    b, t, h, d = q.shape
    vis = (tags[:, None, :lim] >= 0) & (tags[:, None, :lim] <= q_pos[:, :, None])
    slots, pairs = int(vis.any(dim=1).sum()), int(vis.sum())
    kv_bytes = 2 * slots * k_cache.shape[2] * d * k_cache.element_size()
    return bound_ms(kv_bytes + 4 * b * lim + nbytes(q, q_pos) + q.numel() * 4,
                    4.0 * pairs * h * d)


# --------------------------------------------------------------------------
# phase 1


def phase_device(out_dir: pathlib.Path):
    import torch

    from eagle_tpu_torch import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    log(f"[device] {smi.splitlines()[0]}")
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[-1]
    log(f"[device] nvcc {nvcc}; torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t0 = time.time()
    path, ptxas = _build.build()
    log(f"[build] {path.name} in {time.time() - t0:.1f} s")
    (out_dir / "ptxas.txt").write_text(ptxas)
    for line in ptxas.splitlines():
        spills = "bytes spill" in line and "0 bytes spill stores, 0 bytes spill loads" not in line
        if "registers" in line or spills:
            log(f"[ptxas] {line.strip()}")
    return smi.splitlines()[0]


# --------------------------------------------------------------------------
# phase 2


def qmm_checks(report: dict) -> tuple[dict, dict, dict]:
    """qmm against qmm_plain at the main paths' shapes and forms; returns the
    per-token row (1 row, the gemv body), the wqkv row at 512 rows (wgmma
    body) and the wqkv row at 6 rows (small-row mma.sync body), each with
    the worst error of its body."""
    import torch

    from eagle_tpu_torch import _build
    from eagle_tpu_torch.gguf import GGMLType
    from eagle_tpu_torch.models.synth import synth_qtensor
    from eagle_tpu_torch.ops.qmm import qmm, qmm_plain, qmm_stacked
    from eagle_tpu_torch.quant.qtensor import Q4_K, Q6_K

    gen = torch.Generator(device="cuda").manual_seed(7)
    Q4_0, Q8_0 = int(GGMLType.Q4_0), int(GGMLType.Q8_0)
    stack, layer = 6, 5
    # (name, N, K, stacked, synth kwargs); per-token decode count of each
    specs = [
        ("wqkv", 12288, 4096, True, dict(packed=True, coded=True), 32),
        ("wo", 4096, 4096, True, dict(packed=True, coded=True), 32),
        ("w_gate_up", 22016, 4096, True, dict(packed=True, coded=True), 32),
        ("w_down", 4096, 11008, True, dict(packed=True, coded=True), 32),
        ("lm_head", 32000, 4096, False, dict(packed=True, coded=True), 1),
        ("fc_w_draft", 4096, 8192, False, dict(packed=True), 0),
        ("lm_head_q6k_form", 32000, 4096, False, dict(qtype=Q6_K, coded=True), 0),
        # the remaining branches: unpacked codes with a bias, bf16 scales and bias
        ("wo_int8_bf16", 4096, 4096, True, dict(scale_dtype=torch.bfloat16), 0),
        # the GGUF path's forms: Q4_0 (packed, f32 scale and bias -8d) and Q8_0
        # (int8 codes over [-128, 127], f32 scale, no bias; the draft's form,
        # stacked here so that repeats do not hit in L2)
        ("wqkv_q4_0", 12288, 4096, True, dict(qtype=Q4_0, packed=True), 0),
        ("w_down_q4_0", 4096, 11008, True, dict(qtype=Q4_0, packed=True), 0),
        ("wqkv_q8_0", 12288, 4096, True, dict(qtype=Q8_0), 0),
        ("fc_w_q8_0", 4096, 8192, True, dict(qtype=Q8_0), 0),
    ]
    rows_list = (1, 6, 37, 512)  # 37: a ragged row tile of either body
    tree_rows = (1, 6, *TREE_ROWS, 37, 512)  # the forms of a verify forward
    gguf_rows = (1, 6, 512)
    results = []
    worst = worst_tc = worst_mma = 0.0  # worst: the gemv body (1 row)
    per_token = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0}
    per_prompt = dict(per_token)
    per_verify = dict(per_token)
    per_tree = {r: dict(per_token) for r in TREE_ROWS}
    tc_row = mma_row = None
    for name, n, k, stacked, kw, count in specs:
        kw = {"qtype": Q4_K, **kw}
        w = synth_qtensor(gen, n, k, stack=stack if stacked else None, **kw)
        layers = [w.layer(i) for i in range(stack)] if stacked else [w]
        dense = [lw.dequantize(torch.bfloat16).T.contiguous() for lw in layers]  # [K, N]
        w_bytes = nbytes(*layers[0].tensors().values())
        # the tensor-core body's row tiles (64, 128) and their ragged edges:
        # checked only
        for rows in TC_CHECK_ROWS:
            x = torch.randn((rows, k), generator=gen, device="cuda")
            _build.reset_counts()
            got = qmm_stacked(x, w, layer) if stacked else qmm(x, w)
            if _build.launches["qmm_tc"] != 1:
                raise AssertionError(f"qmm {name} rows={rows}: not the tensor-core body")
            want = qmm_plain(x, layers[layer if stacked else 0])
            torch.cuda.synchronize()
            abs_err, rel = rel_err(got, want)
            if rel > QMM_TOL or not bool(torch.isfinite(got).all()):
                raise AssertionError(f"qmm {name} rows={rows}: rel err {rel:.3e} > {QMM_TOL}")
            worst_tc = max(worst_tc, abs_err)
        log(f"[qmm] {name:16s} tensor-core body at rows {TC_CHECK_ROWS}: rel err <= {QMM_TOL}")
        # the small-row tensor-core body (qmm_mma) at verify rows: checked only
        for rows in MMA_CHECK_ROWS:
            x = torch.randn((rows, k), generator=gen, device="cuda")
            _build.reset_counts()
            got = qmm_stacked(x, w, layer) if stacked else qmm(x, w)
            if _build.launches["qmm_mma"] != 1:
                raise AssertionError(f"qmm {name} rows={rows}: not the small-row body")
            want = qmm_plain(x, layers[layer if stacked else 0])
            torch.cuda.synchronize()
            abs_err, rel = rel_err(got, want)
            if rel > QMM_TOL or not bool(torch.isfinite(got).all()):
                raise AssertionError(f"qmm {name} rows={rows}: rel err {rel:.3e} > {QMM_TOL}")
            worst_mma = max(worst_mma, abs_err)
        log(f"[qmm] {name:16s} small-row body at rows {MMA_CHECK_ROWS}: rel err <= {QMM_TOL}")
        for rows in (gguf_rows if kw["qtype"] in (Q4_0, Q8_0) else
                     tree_rows if count else rows_list):
            x = torch.randn((rows, k), generator=gen, device="cuda")
            _build.reset_counts()
            if stacked:
                got = qmm_stacked(x, w, layer)
            else:
                got = qmm(x, w)
            if rows == 1 and (_build.launches["qmm_gemv"] != 1
                              or sum(_build.launches.values()) != 1):
                raise AssertionError(f"qmm {name} rows=1: not the gemv body: {_build.launches}")
            want = qmm_plain(x, layers[layer if stacked else 0])
            torch.cuda.synchronize()
            if not bool(torch.isfinite(got).all()):
                raise AssertionError(f"qmm {name} rows={rows}: non-finite output")
            abs_err, rel = rel_err(got, want)
            if rel > QMM_TOL:
                raise AssertionError(f"qmm {name} rows={rows}: rel err {rel:.3e} > {QMM_TOL}")
            if rows == 1:
                worst = max(worst, abs_err)
                log(f"[qmm] {name:16s} gemv body at rows (1,): rel err {rel:.2e} <= {QMM_TOL}")
            reps = 20 if rows < 512 else 5
            # cycle over the stack's layers so that repeats do not hit in L2
            if stacked:
                ms = device_ms(lambda i: qmm_stacked(x, w, i % stack), reps)
            else:
                ms = device_ms(lambda i: qmm(x, w), reps)
            plain = device_ms(lambda i: qmm_plain(x, layers[i % len(layers)]), 3, warmup=1)
            xb = x.to(torch.bfloat16)
            lib = device_ms(lambda i: torch.matmul(xb, dense[i % len(dense)]), reps)
            b_ms, b_by = bound_ms(w_bytes + rows * k * 4 + rows * n * 4, 2.0 * rows * k * n)
            res = dict(name=name, n=n, k=k, rows=rows, ms=ms, plain_ms=plain, bound_ms=b_ms,
                       bound_by=b_by, library_ms=lib, max_abs_err=abs_err, rel_err=rel,
                       weight_bytes=w_bytes)
            results.append(res)
            log(f"[qmm] {name:16s} N={n:5d} K={k:5d} rows={rows:3d}  kernel {ms:8.4f} ms  "
                f"plain {plain:8.3f} ms  bound {b_ms * 1e3:8.2f} us ({b_by})  "
                f"library {lib:8.4f} ms  rel err {rel:.2e}")
            if rows == 1 and count:
                for key in per_token:
                    per_token[key] += count * res[key]
            if rows > 8:
                worst_tc = max(worst_tc, abs_err)
            elif rows > 1:
                worst_mma = max(worst_mma, abs_err)
            if rows == 512 and count:
                for key in per_prompt:
                    per_prompt[key] += count * res[key]
            if rows == VERIFY_ROWS and count:
                for key in per_verify:
                    per_verify[key] += count * res[key]
            if rows in TREE_ROWS:
                for key in per_tree[rows]:
                    per_tree[rows][key] += count * res[key]
            if rows in (1, VERIFY_ROWS, *TREE_ROWS, 512):
                log_ratios("qmm", res)
            if name == "wqkv" and rows == 512:
                tc_row = dict(res)
            if name == "wqkv" and rows == VERIFY_ROWS:
                mma_row = dict(res)
        del w, layers, dense
        torch.cuda.empty_cache()
    report["qmm"] = results
    report["qmm_prefill_per_prompt"] = per_prompt
    report["qmm_per_verify_cycle"] = per_verify
    report["qmm_per_tree_verify"] = per_tree
    report["qmm_per_decoded_token"] = per_token
    parent_tok = PARENT.get(("qmm_token", "per_token", 1))
    vs = (f", parent {parent_tok:.3f} ms = {parent_tok / per_token['ms']:.2f}x this"
          if parent_tok else "")
    log(f"[qmm] per decoded token (32 x 4 projections + lm_head, 1 row, gemv body): kernel "
        f"{per_token['ms']:.3f} ms, bound {per_token['bound_ms']:.3f} ms, library "
        f"{per_token['library_ms']:.3f} ms{vs}")
    log(f"[qmm] prefill per prompt (32 x 4 projections + lm_head, 512 rows, tensor-core body): "
        f"kernel {per_prompt['ms']:.3f} ms, bound {per_prompt['bound_ms']:.3f} ms, library "
        f"{per_prompt['library_ms']:.3f} ms")
    log(f"[qmm] per EAGLE verify cycle (32 x 4 projections + lm_head, {VERIFY_ROWS} rows, "
        f"small-row body): kernel {per_verify['ms']:.3f} ms, bound {per_verify['bound_ms']:.3f} "
        f"ms, library {per_verify['library_ms']:.3f} ms")
    for rows, r in per_tree.items():
        log(f"[qmm] per tree verify (32 x 4 projections + lm_head, {rows} rows, tensor-core "
            f"body, 129 launches): kernel {r['ms']:.3f} ms, bound {r['bound_ms']:.3f} ms, plain "
            f"{r['plain_ms']:.3f} ms, library {r['library_ms']:.3f} ms")
    tc_row["max_abs_err"] = worst_tc
    mma_row["max_abs_err"] = worst_mma
    return dict(per_token, max_abs_err=worst, bound_by="bytes"), tc_row, mma_row


def ragged_checks(report: dict) -> dict:
    """qmm and qmm_i4 at shapes the tensor-core bodies cannot address and
    the reference serves with a whole-N tile: N = 4001 (N % 4 != 0), N = 4100
    (N % 16 != 0), K = 4128 (K % 64 != 0), at 1, 6 and 37 rows, bf16
    compute, through the stacked entry (layer 2 of 3), against the plain
    versions (relative error <= 1e-2); the route each call took is printed
    (the SIMT body for all of them, masked at the last column where N % 4 !=
    0). qmm at N = 4001, K = 4096 is timed at 1 and 6 rows, with its bound
    and library_ms. Returns the 1-row N = 4001 row (the SIMT body)."""
    import torch

    from eagle_tpu_torch import _build
    from eagle_tpu_torch.gguf import GGMLType
    from eagle_tpu_torch.models.synth import synth_qtensor
    from eagle_tpu_torch.ops.qmm import (qmm_i4_plain, qmm_i4_stacked, qmm_plain, qmm_stacked)
    from eagle_tpu_torch.quant.qtensor import Q4_K

    gen = torch.Generator(device="cuda").manual_seed(19)
    bf16 = torch.bfloat16
    results = []

    def int4(n, k):
        return int4_stack(gen, n, k, 3)

    simt_row = None
    forms = (("q4_0", lambda n, k: synth_qtensor(gen, n, k, int(GGMLType.Q4_0), 3, packed=True),
              qmm_stacked, qmm_plain),
             ("q4k_coded", lambda n, k: synth_qtensor(gen, n, k, Q4_K, 3, packed=True, coded=True),
              qmm_stacked, qmm_plain),
             ("int4", int4, qmm_i4_stacked, qmm_i4_plain))
    for form, make, run, plain in forms:
        for n, k in ((4001, 4096), (4100, 4096), (4096, 4128)):
            if form == "q4k_coded" and k % 256:
                continue  # coded weights have K % 256 == 0
            w = make(n, k)
            for rows in (1, 6, 37):
                x = torch.randn((rows, k), generator=gen, device="cuda")
                _build.reset_counts()
                got = run(x, w, 2)
                route = [name for name, c in _build.launches.items() if c]
                torch.cuda.synchronize()
                abs_err, rel = rel_err(got, plain(x, w.layer(2)))
                if rel > QMM_TOL or not bool(torch.isfinite(got).all()):
                    raise AssertionError(f"{form} N={n} K={k} rows={rows}: rel err {rel:.3e}")
                if route != (["qmm_i4"] if form == "int4" else ["qmm"]):
                    raise AssertionError(f"{form} N={n} K={k} rows={rows}: route {route}, not SIMT")
                log(f"[ragged] {form:9s} N={n} K={k} rows={rows:2d}: route {route}, rel err "
                    f"{rel:.2e}")
                if form == "q4_0" and n == 4001 and rows in (1, VERIFY_ROWS):
                    lw = w.layer(2)
                    dense = lw.dequantize(bf16).T.contiguous()
                    xb = x.to(bf16)
                    ms = device_ms(lambda i: run(x, w, i % 3), 20)
                    plain_ms = device_ms(lambda i: plain(x, lw), 3, warmup=1)
                    lib = device_ms(lambda i: torch.matmul(xb, dense), 20)
                    w_bytes = nbytes(*lw.tensors().values())
                    b_ms, b_by = bound_ms(w_bytes + rows * k * 4 + rows * n * 4,
                                          2.0 * rows * k * n)
                    res = dict(name=f"{form}_n{n}", n=n, k=k, rows=rows, route=route, ms=ms,
                               plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib,
                               max_abs_err=abs_err, rel_err=rel)
                    results.append(res)
                    if rows == 1:
                        simt_row = dict(res)
                    log(f"[ragged] {form} N={n} K={k} rows={rows}: kernel {ms:.4f} ms, plain "
                        f"{plain_ms:.3f} ms, bound {b_ms * 1e3:.2f} us ({b_by}), library "
                        f"{lib:.4f} ms")
            del w
    report["ragged"] = results
    return simt_row


def int4_stack(gen, n: int, k: int, stack: int, group: int = 32, scale_dtype=None,
               bias: bool = True):
    """A layer stack of int4 "kn" weights (kernel_bench's form: signed
    nibbles, bf16 scale and bias by default), random from `gen`."""
    import torch

    from eagle_tpu_torch.quant.qtensor import QTensor, pack_int4

    sd = scale_dtype or torch.bfloat16
    q = torch.randint(-8, 8, (stack, k, n), generator=gen, device="cuda", dtype=torch.int8)
    scale = torch.rand((stack, k // group, n), generator=gen, device="cuda") * 1e-2
    b = torch.randn((stack, k // group, n), generator=gen, device="cuda") * 1e-3
    return QTensor(q=pack_int4(q, group), group=group, layout="kn", int4=True,
                   scale=scale.to(sd), bias=b.to(sd) if bias else None)


def qmm_i4_small_row_checks(report: dict) -> float:
    """qmm_i4 and qmm_i4_stacked (layer 2 of 3) against qmm_i4_plain on the
    small-row tensor-core body (qmm_i4_mma), bf16 compute, at the 7B
    projections (N, K) = (12288, 4096) and (4096, 11008) and at 2, 3, 6 and
    8 rows: kernel_bench's form (G 32, bf16 scale and bias) and G 16 with
    an f32 scale and no bias (relative error <= 1e-2; checks only, phase 7
    times them). Each call is asserted to launch qmm_i4_mma once. Returns
    the largest abs error."""
    import torch

    from eagle_tpu_torch import _build
    from eagle_tpu_torch.ops.qmm import qmm_i4, qmm_i4_plain, qmm_i4_stacked

    gen = torch.Generator(device="cuda").manual_seed(23)
    worst, results = 0.0, []
    for form, kw in (("g32_bf16_bias", {}),
                     ("g16_f32_nobias", dict(group=16, scale_dtype=torch.float32, bias=False))):
        for name, n, k in (("wqkv", 12288, 4096), ("w_down", 4096, 11008)):
            w = int4_stack(gen, n, k, 3, **kw)
            for rows in MMA_CHECK_ROWS:
                x = torch.randn((rows, k), generator=gen, device="cuda")
                for entry in ("2-D", "stacked"):
                    _build.reset_counts()
                    got = qmm_i4(x, w.layer(2)) if entry == "2-D" else qmm_i4_stacked(x, w, 2)
                    launched = dict(_build.launches)
                    abs_err, rel = rel_err(got, qmm_i4_plain(x, w.layer(2)))
                    if launched["qmm_i4_mma"] != 1 or sum(launched.values()) != 1:
                        raise AssertionError(f"qmm_i4 {entry} {name} {form} rows={rows}: not the "
                                             f"small-row body: {launched}")
                    if rel > QMM_TOL or not bool(torch.isfinite(got).all()):
                        raise AssertionError(f"qmm_i4 {entry} {name} {form} rows={rows}: rel err "
                                             f"{rel:.3e} > {QMM_TOL}")
                    worst = max(worst, abs_err)
                    results.append(dict(name=name, form=form, rows=rows, entry=entry,
                                        max_abs_err=abs_err, rel_err=rel))
            log(f"[qmm_i4] {name:8s} {form:14s} small-row body at rows {MMA_CHECK_ROWS}, 2-D and "
                f"stacked: rel err <= {max(r['rel_err'] for r in results):.2e}")
            del w
    report["qmm_i4_small_row_checks"] = results
    return worst


def ffn_checks(report: dict) -> tuple[dict, dict]:
    """ffn_out_norm and gate_up_act against their plain versions at
    Vicuna-7B widths (D 4096, F 11008, H*Dh 4096), 1 and 6 rows, bf16
    compute: the target's stacked Q4_0 form (layer 5 of 6) and the draft's
    single-layer Q8_0 form (six copies, cycled so that repeats do not hit in
    L2), checked at 1, 2, 6, 9, 32, 33 and 64 rows (the 1-row tensor-core
    body at 1 row, gate_up_act's paired and asserted bit-equal to silu(g) *
    u from qmm_stacked's sums; the small-row tensor-core body above) and
    timed at 1, 6 and 32 rows (decode, chain verify, EAGLE-2 verify),
    each time as a ratio to library_ms and, with --parent-report, to the
    parent's kernel. library_ms is torch.matmul of the same rows with the
    pre-dequantized bf16 weight (the product alone: no single PyTorch call
    computes the fused epilogue). Returns the 1-row Q4_0 rows of each
    kernel, with the worst error over all checks."""
    import torch

    import torch.nn.functional as F

    from eagle_tpu_torch.gguf import GGMLType
    from eagle_tpu_torch.models.synth import synth_qtensor
    from eagle_tpu_torch.ops.ffn import (_body, ffn_out_norm, ffn_out_norm_plain, gate_up_act,
                                         gate_up_act_plain)
    from eagle_tpu_torch.ops.qmm import qmm_stacked

    gen = torch.Generator(device="cuda").manual_seed(13)
    d, f, hd, eps, copies = 4096, 11008, 4096, 1e-6, 6
    bf16 = torch.bfloat16
    forms = (("q4_0", dict(qtype=int(GGMLType.Q4_0), packed=True), copies),
             ("q8_0_draft", dict(qtype=int(GGMLType.Q8_0)), 1))
    results, decode = [], {}
    worst = {"ffn_out_norm": 0.0, "gate_up_act": 0.0}
    for form, kw, stack in forms:
        def variants(n, k):
            """six (weight, layer) pairs: the layers of one stack, or six
            single-layer stacks"""
            if stack > 1:
                w = synth_qtensor(gen, n, k, stack=stack, **kw)
                return [(w, i) for i in range(stack)]
            return [(synth_qtensor(gen, n, k, stack=1, **kw), 0) for _ in range(copies)]

        for name, n, k in (("ffn_out_norm", d, hd), ("gate_up_act", 2 * f, d)):
            ws = variants(n, k)
            dense = [w.layer(i).dequantize(bf16).T.contiguous() for w, i in ws]  # [K, N]
            w_bytes = nbytes(*ws[0][0].layer(0).tensors().values())
            for rows in FFN_CHECK_ROWS:
                w, layer = ws[-1]
                if name == "ffn_out_norm":
                    attn = torch.randn((rows, hd), generator=gen, device="cuda")
                    resid = torch.randn((rows, d), generator=gen, device="cuda")
                    nw = torch.rand((d,), generator=gen, device="cuda") + 0.5
                    x, h = ffn_out_norm(attn, resid, nw, w, layer, eps, bf16)
                    xw, hw = ffn_out_norm_plain(attn, resid, nw, w.layer(layer), eps, bf16)
                    pairs = ((x, xw), (h, hw))
                    run = lambda i: ffn_out_norm(attn, resid, nw, *ws[i % copies], eps, bf16)
                    plain_run = lambda i: ffn_out_norm_plain(
                        attn, resid, nw, ws[i % copies][0].layer(ws[i % copies][1]), eps, bf16)
                    lib_in = attn.to(bf16)
                    io_bytes = rows * hd * 4 + 2 * rows * d * 4 + d * 4 + rows * d * 2
                else:
                    hin = torch.randn((rows, d), generator=gen, device="cuda").to(bf16)
                    got = gate_up_act(hin, w, layer, "silu", bf16)
                    pairs = ((got, gate_up_act_plain(hin, w.layer(layer), "silu", bf16)),)
                    if rows == 1:  # the paired 1-row body: g and u are qmm's sums
                        if _body(1, k, n, w, bf16, paired=True) != "gemv":
                            raise AssertionError(f"gate_up_act {form} rows=1: not the gemv body")
                        g, u = qmm_stacked(hin, w, layer).chunk(2, dim=-1)
                        if not torch.equal(got, (F.silu(g) * u).to(bf16)):
                            raise AssertionError(f"gate_up_act {form} rows=1: not act(g) * u of "
                                                 f"qmm's sums, bit for bit")
                        log(f"[ffn] gate_up_act  {form:10s} rows=1: gemv body, bit-equal to "
                            f"silu(g) * u from qmm_stacked's sums")
                    run = lambda i: gate_up_act(hin, *ws[i % copies], "silu", bf16)
                    plain_run = lambda i: gate_up_act_plain(
                        hin, ws[i % copies][0].layer(ws[i % copies][1]), "silu", bf16)
                    lib_in = hin
                    io_bytes = rows * d * 2 + rows * f * 2
                torch.cuda.synchronize()
                abs_err = rel = 0.0
                for got, want in pairs:
                    if not bool(torch.isfinite(got).all()):
                        raise AssertionError(f"{name} {form} rows={rows}: non-finite output")
                    a, r = rel_err(got, want)
                    abs_err, rel = max(abs_err, a), max(rel, r)
                if rel > QMM_TOL:
                    raise AssertionError(f"{name} {form} rows={rows}: rel err {rel:.3e} > {QMM_TOL}")
                worst[name] = max(worst[name], abs_err)
                if rows not in (1, VERIFY_ROWS, TREE_ROWS[1]):
                    log(f"[ffn] {name:12s} {form:10s} rows={rows}: rel err {rel:.2e}")
                    continue
                ms = device_ms(run, 20)
                plain = device_ms(plain_run, 3, warmup=1)
                lib = device_ms(lambda i: torch.matmul(lib_in, dense[i % copies]), 20)
                b_ms, b_by = bound_ms(w_bytes + io_bytes, 2.0 * rows * k * n)
                res = dict(name=name, form=form, n=n, k=k, rows=rows, ms=ms, plain_ms=plain,
                           bound_ms=b_ms, bound_by=b_by, library_ms=lib, max_abs_err=abs_err,
                           rel_err=rel, weight_bytes=w_bytes)
                results.append(res)
                log(f"[ffn] {name:12s} {form:10s} N={n:5d} K={k:5d} rows={rows}  kernel {ms:8.4f} ms"
                    f"  plain {plain:8.3f} ms  bound {b_ms * 1e3:8.2f} us ({b_by})  library "
                    f"{lib:8.4f} ms  rel err {rel:.2e}")
                if form == "q4_0" and rows == 1:
                    decode[name] = dict(res)
                log_ratios("ffn", dict(res, name=f"{name}/{form}"))
            del ws, dense
            torch.cuda.empty_cache()
    report["ffn"] = results
    for name in decode:
        decode[name]["max_abs_err"] = worst[name]
    return decode["ffn_out_norm"], decode["gate_up_act"]


def attention_checks(report: dict) -> tuple[dict, dict]:
    import numpy as np
    import torch
    import torch.nn.functional as F

    from eagle_tpu_torch.ops import flash_attention as fa
    from eagle_tpu_torch.runtime.kvcache import causal_mask_from_tags
    from eagle_tpu_torch.runtime.tree import TreeSpec, _tree_mask
    from eagle_tpu_torch.runtime.tree2 import _window_tree_mask

    gen = torch.Generator(device="cuda").manual_seed(11)
    n_layers, b, h, d, s = 2, 1, 32, 128, 1024
    k_cache = torch.randn((n_layers, b, h, s, d), generator=gen, device="cuda").to(torch.bfloat16)
    v_cache = torch.randn((n_layers, b, h, s, d), generator=gen, device="cuda").to(torch.bfloat16)
    layer = 1
    decode = {}
    worst = 0.0
    results = []
    # (mask kind, T, s_limit, mask): decode and chain verify after 900
    # tokens with rolled-back holes; the EAGLE engine's prompt (300 tokens in
    # a 512 bucket), which takes this kernel too
    cases = []
    for t in (1, 6):
        tags = torch.full((b, s), -1, dtype=torch.int32, device="cuda")
        tags[:, : 900 + t] = torch.arange(900 + t, dtype=torch.int32, device="cuda")
        tags[:, 100:140] = -1
        pos = 900 + torch.arange(t, dtype=torch.int32, device="cuda")
        cases.append(("causal", t, s, causal_mask_from_tags(tags, pos[None])))
    tags = torch.full((b, s), -1, dtype=torch.int32, device="cuda")
    tags[:, :300] = torch.arange(300, dtype=torch.int32, device="cuda")
    pos = torch.arange(512, dtype=torch.int32, device="cuda")
    cases.append(("causal", 512, 512, causal_mask_from_tags(tags[:, :512], pos[None])))
    # the tree verify forwards after 900 committed tokens with holes: the
    # static tree's ancestor mask (29 rows) and an EAGLE-2 window of 32 rows
    # (a random tree: each row's parent an earlier row)
    base = torch.full((b,), 900, dtype=torch.int32, device="cuda")
    spec = TreeSpec(TREE_SPEC)
    tags = torch.full((b, s), -1, dtype=torch.int32, device="cuda")
    tags[:, :900] = torch.arange(900, dtype=torch.int32, device="cuda")
    tags[:, 100:140] = -1
    ids = torch.arange(spec.n_nodes, dtype=torch.int32, device="cuda")
    depth = torch.from_numpy(spec.depth).cuda()
    tags[:, 900:900 + spec.n_nodes] = 900 + depth
    cases.append(("tree", spec.n_nodes, s, _tree_mask(
        tags, (900 + depth)[None], base, ids, torch.from_numpy(spec.ancestor).cuda(),
        spec.n_nodes)))
    n = TREE2["n_verify"]
    rng = np.random.default_rng(11)
    parent = [-1] + [int(rng.integers(0, j)) for j in range(1, n)]
    anc = torch.eye(n, dtype=torch.bool)
    rows_depth = [0] * n
    for j in range(1, n):
        anc[j] |= anc[parent[j]]
        rows_depth[j] = rows_depth[parent[j]] + 1
    depth = torch.tensor(rows_depth, dtype=torch.int32, device="cuda")
    tags[:, 900:900 + n] = 900 + depth
    cases.append(("tree2", n, s, _window_tree_mask(tags, (900 + depth)[None], base,
                                                   anc.cuda()[None])))
    for kind, t, lim, mask in cases:
        q = torch.randn((b, t, h, d), generator=gen, device="cuda")
        got = fa.flash_attention_cached(q, k_cache, v_cache, mask, layer, s_limit=lim)
        want = fa.flash_attention_cached_plain(q, k_cache, v_cache, mask, layer, s_limit=lim)
        torch.cuda.synchronize()
        abs_err, rel = rel_err(got, want)
        if rel > ATTN_TOL or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"flash_decode T={t} {kind} mask: rel err {rel:.3e} > {ATTN_TOL}")
        worst = max(worst, abs_err)
        reps = 50 if t < 512 else 10
        ms = device_ms(lambda i: fa.flash_attention_cached(q, k_cache, v_cache, mask, layer,
                                                          s_limit=lim), reps)
        plain = device_ms(lambda i: fa.flash_attention_cached_plain(q, k_cache, v_cache, mask,
                                                                   layer, s_limit=lim), 10)
        qb = q.transpose(1, 2).to(torch.bfloat16)
        am = mask[:, None]
        kl, vl = k_cache[layer, :, :, :lim], v_cache[layer, :, :, :lim]
        lib = device_ms(lambda i: F.scaled_dot_product_attention(qb, kl, vl, attn_mask=am), reps)
        b_ms, b_by = bound_ms(2 * b * h * lim * d * 2 + nbytes(q, mask) + q.numel() * 4,
                              4.0 * b * h * t * lim * d)
        res = dict(name="flash_decode", mask=kind, t=t, s=lim, ms=ms, plain_ms=plain,
                   bound_ms=b_ms, bound_by=b_by, library_ms=lib, max_abs_err=abs_err, rel_err=rel)
        results.append(res)
        log(f"[flash_decode] T={t} S={lim} H={h} D={d} {kind} mask  kernel {ms:.4f} ms  plain "
            f"{plain:.4f} ms  bound {b_ms * 1e3:.2f} us ({b_by})  library {lib:.4f} ms  rel err "
            f"{rel:.2e}{vs_parent(res)}")
        if t == 1:
            decode = dict(res)
    decode["max_abs_err"] = worst

    t, n, lim = 512, 300, 512
    tags = torch.full((b, s), -1, dtype=torch.int32, device="cuda")
    tags[:, :n] = torch.arange(n, dtype=torch.int32, device="cuda")
    q_pos = torch.arange(t, dtype=torch.int32, device="cuda")[None].clone()
    q_pos[:, -8:] = -1  # rows that see nothing: the uniform average
    q_pos[:, 100] = -1  # one inside a 64-row tile whose other rows see keys
    q = torch.randn((b, t, h, d), generator=gen, device="cuda")
    got = fa.flash_attention_prefill(q, k_cache, v_cache, q_pos, tags, layer, s_limit=lim)
    want = fa.flash_attention_prefill_plain(q, k_cache, v_cache, q_pos, tags, layer, s_limit=lim)
    torch.cuda.synchronize()
    abs_err, rel = rel_err(got, want)
    if rel > ATTN_TOL or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"flash_prefill: rel err {rel:.3e} > {ATTN_TOL}")
    uniform = v_cache[layer, :, :, :lim].float().mean(dim=2)  # [B, H, D]
    for row in (100, t - 1):
        _, rel_u = rel_err(got[:, row], uniform)
        if rel_u > ATTN_TOL:
            raise AssertionError(f"flash_prefill: q_pos=-1 row {row} is not the uniform average "
                                 f"({rel_u:.2e})")
    ms = device_ms(lambda i: fa.flash_attention_prefill(q, k_cache, v_cache, q_pos, tags, layer,
                                                       s_limit=lim), 10)
    plain = device_ms(lambda i: fa.flash_attention_prefill_plain(q, k_cache, v_cache, q_pos, tags,
                                                                layer, s_limit=lim), 5)
    vis = (tags[:, None, :lim] >= 0) & (tags[:, None, :lim] <= q_pos[:, :, None])
    vis[:, -8:, 0] = True  # SDPA gives NaN on rows that see nothing
    qb = q.transpose(1, 2).to(torch.bfloat16)
    lib = device_ms(lambda i: F.scaled_dot_product_attention(
        qb, k_cache[layer, :, :, :lim], v_cache[layer, :, :, :lim], attn_mask=vis[:, None]), 10)
    b_ms, b_by = prefill_bound(q, k_cache, q_pos, tags, lim)
    prefill = dict(name="flash_prefill", t=t, s=lim, ms=ms, plain_ms=plain, bound_ms=b_ms,
                   bound_by=b_by, library_ms=lib, max_abs_err=abs_err, rel_err=rel)
    results.append(prefill)
    log(f"[flash_prefill] T={t} S={lim} H={h} D={d}  kernel {ms:.4f} ms  plain {plain:.4f} ms  "
        f"bound {b_ms * 1e3:.2f} us ({b_by})  library {lib:.4f} ms  rel err {rel:.2e}"
        f"{vs_parent(prefill)}")
    results += prefill_offset_checks(gen, k_cache, v_cache, layer)
    report["attention"] = results
    del k_cache, v_cache
    torch.cuda.empty_cache()
    report["attention_gqa"] = gqa_checks(gen)
    report["attention_d256"] = head256_checks(gen)
    return decode, prefill


#: (query heads, KV heads) of the head-width-256 layouts (each config.json):
#: Gemma-7B (g = 1), Gemma-2-9B (g = 2), Gemma-2B (g = 8)
GEMMA_HEADS = {"gemma-7b": (16, 16), "gemma-2-9b": (16, 8), "gemma-2b": (8, 1)}
F32_ATTN_TOL = 1e-4  # f32 cache: the SIMT body's exact FMAs, summed in another order


def head256_checks(gen) -> list[dict]:
    """Both flash kernels at D = 256 against their plain versions, bf16
    and f32 caches, at GEMMA_HEADS' layouts: decode (T = 1) and a K = 5
    verify (T = 6; Gemma-2B's is 48 rows per kv head) over S = 1,024 (906
    tokens with a hole) at s_limit 300 and 1,024, row 3 of each T = 6 call
    fully masked; a 512-row prompt over 300 tagged slots, its rows 100
    (inside a 64-row tile) and 504-511 with q_pos = -1. With a bf16 cache
    also: the prompt as `Generator._prefill` lays it out (rows at positions
    0-511, the 212 past the prompt padding, tags -1 past slot 299, no q_pos
    = -1 row: case "generator"); the EAGLE engine's prompt through
    flash_decode (T = 512 under the causal tag mask, s_limit 512: case
    "eagle prompt", and with its row 100 masked whole, inside a 64-row
    block: "eagle prompt masked row"); and phase chat's feeds (`CHAT_FEEDS`)
    at g = 1 and 2 (case "chat feed"). Each fully masked row must be the
    uniform average of V over [0, s_limit). The s_limit 1,024 calls, the
    prompts and the feeds are timed: kernel, plain, bound and SDPA
    (`enable_gqa` where g > 1); the bound counts K and V of the slots some
    row sees and the (query, key) pairs seen (`prefill_bound`,
    `decode_bound`). Each line names the plan (body: flash_decode's
    "mma_cluster" below 64 rows per kv head, its splits merged in the
    launch, or "wgmma"; rows, splits) and, for the wgmma body, the 64-key
    tiles it reads and skips, from the Python mirrors of its rules
    (`flash_attention.tile_reads`: rule B; `tile_reads_mask`: rule M).
    Tolerance: bf16 ATTN_TOL, f32 F32_ATTN_TOL."""
    import torch
    import torch.nn.functional as F

    from eagle_tpu_torch.ops import flash_attention as fa
    from eagle_tpu_torch.runtime.kvcache import causal_mask_from_tags

    b, d, s, layer = 1, 256, 1024, 1
    slots = torch.arange(s, dtype=torch.int32, device="cuda")[None]
    log(f"[flash d256] mma_cluster: clusters of 1-8 blocks a wave "
        f"(cudaOccupancyMaxActiveClusters) at 16 rows {fa.cluster_wave(16)}, at 32 rows "
        f"{fa.cluster_wave(32)}; _plan's table {fa._CLUSTER_WAVE}")
    out = []
    for model, (h, h_kv) in GEMMA_HEADS.items():
        g = h // h_kv
        for dtype in (torch.bfloat16, torch.float32):
            tol = ATTN_TOL if dtype == torch.bfloat16 else F32_ATTN_TOL
            kc = torch.randn((2, b, h_kv, s, d), generator=gen, device="cuda").to(dtype)
            vc = torch.randn((2, b, h_kv, s, d), generator=gen, device="cuda").to(dtype)
            cases = []  # (name, case, T, s_limit, masked row, q, inputs)
            for t in (1, VERIFY_ROWS):
                tags = torch.full((b, s), -1, dtype=torch.int32, device="cuda")
                tags[:, :900 + t] = torch.arange(900 + t, dtype=torch.int32, device="cuda")
                tags[:, 100:140] = -1
                pos = (900 + torch.arange(t, dtype=torch.int32, device="cuda"))[None]
                for lim in (300, s):
                    mask = causal_mask_from_tags(tags[:, :lim], pos)
                    masked = 3 if t > 1 else None
                    if masked is not None:
                        mask[:, masked] = False
                    q = torch.randn((b, t, h, d), generator=gen, device="cuda")
                    cases.append(("flash_decode", "", t, lim, masked, q, dict(mask=mask)))
            t, n, lim = 512, 300, 512
            tags = torch.where(slots < n, slots, -1)
            pos = torch.arange(t, dtype=torch.int32, device="cuda")[None]
            q_pos = pos.clone()
            q_pos[:, -8:] = -1
            q_pos[:, 100] = -1
            q = torch.randn((b, t, h, d), generator=gen, device="cuda")
            cases.append(("flash_prefill", "", t, lim, 100, q, dict(q_pos=q_pos, tags=tags)))
            if dtype == torch.bfloat16:
                q = torch.randn((b, t, h, d), generator=gen, device="cuda")
                cases.append(("flash_prefill", "generator", t, lim, None, q,
                              dict(q_pos=pos, tags=tags)))
                q = torch.randn((b, t, h, d), generator=gen, device="cuda")
                mask = causal_mask_from_tags(tags[:, :lim], pos)
                cases.append(("flash_decode", "eagle prompt", t, lim, None, q, dict(mask=mask)))
                q = torch.randn((b, t, h, d), generator=gen, device="cuda")
                mask = mask.clone()
                mask[:, 100] = False  # its block reads every tile
                cases.append(("flash_decode", "eagle prompt masked row", t, lim, 100, q,
                              dict(mask=mask)))
                for t, n, q0, lim in CHAT_FEEDS if g <= 2 else ():
                    q = torch.randn((b, t, h, d), generator=gen, device="cuda")
                    cases.append(("flash_prefill", "chat feed", t, lim, None, q, dict(
                        q_pos=q0 + torch.arange(t, dtype=torch.int32, device="cuda")[None],
                        tags=torch.where(slots < q0 + n, slots, -1), q0=q0)))
            for name, case, t, lim, masked, q, kw in cases:
                if name == "flash_decode":
                    run = lambda i: fa.flash_attention_cached(  # noqa: E731
                        q, kc, vc, kw["mask"], layer, s_limit=lim)
                    plain = lambda i: fa.flash_attention_cached_plain(  # noqa: E731
                        q, kc, vc, kw["mask"], layer, s_limit=lim)
                    vis = kw["mask"]
                else:
                    run = lambda i: fa.flash_attention_prefill(  # noqa: E731
                        q, kc, vc, kw["q_pos"], kw["tags"], layer, s_limit=lim)
                    plain = lambda i: fa.flash_attention_prefill_plain(  # noqa: E731
                        q, kc, vc, kw["q_pos"], kw["tags"], layer, s_limit=lim)
                    tg = kw["tags"][:, None, :lim]
                    vis = (tg >= 0) & (tg <= kw["q_pos"][:, :, None])
                got = run(0)
                torch.cuda.synchronize()
                abs_err, rel = rel_err(got, plain(0))
                rel_u = 0.0
                if masked is not None:
                    uniform = vc[layer, :, :, :lim].float().mean(dim=2).repeat_interleave(g, dim=1)
                    rel_u = rel_err(got[:, masked], uniform)[1]
                    if name == "flash_prefill":
                        rel_u = max(rel_u, rel_err(got[:, -1], uniform)[1])
                what = f"{name} D=256 {model} {dtype} T={t} s_limit={lim} {case}".rstrip()
                if rel > tol or rel_u > tol or not bool(torch.isfinite(got).all()):
                    raise AssertionError(f"{what}: rel err {rel:.3e}, masked row {rel_u:.3e} > "
                                         f"{tol}")
                plan = fa._plan(t * g, lim, d, dtype, b * h_kv, name == "flash_prefill")
                res = dict(name=name, model=model, h=h, h_kv=h_kv, g=g, d=d,
                           dtype=str(dtype).replace("torch.", ""), t=t, s=lim,
                           max_abs_err=abs_err, rel_err=rel, masked_row_rel_err=rel_u,
                           plan=plan._asdict())
                if case:
                    res["case"] = case
                if "q0" in kw:
                    res["q0"] = kw["q0"]
                reads = ""
                if plan.body == "wgmma":
                    read = (fa.tile_reads_mask(kw["mask"], g) if name == "flash_decode"
                            else fa.tile_reads(kw["q_pos"], kw["tags"], lim, g))
                    res.update(tiles_read=int(read.sum()), tiles=read.numel())
                    reads = (f", rule {'M' if name == 'flash_decode' else 'B'}: tiles read "
                             f"{res['tiles_read']} of {res['tiles']}")
                elif plan.body == "mma_cluster":
                    reads = " merged in the launch"
                if lim == s or t >= 128:
                    reps = 50 if t < 512 else 10
                    res["ms"] = device_ms(run, reps)
                    res["plain_ms"] = device_ms(plain, 10 if t < 512 else 5)
                    qs = q.transpose(1, 2).to(dtype)
                    am = vis[:, None].clone()
                    am[..., 0] |= ~am.any(dim=-1)  # SDPA gives NaN on rows that see nothing
                    kl, vl = kc[layer, :, :, :lim], vc[layer, :, :, :lim]
                    res["library_ms"] = device_ms(lambda i: F.scaled_dot_product_attention(
                        qs, kl, vl, attn_mask=am, enable_gqa=g > 1), reps)
                    if name == "flash_decode":
                        b_ms, b_by = decode_bound(q, kc, kw["mask"])
                    else:
                        b_ms, b_by = prefill_bound(q, kc, kw["q_pos"], kw["tags"], lim)
                    res.update(bound_ms=b_ms, bound_by=b_by)
                out.append(res)
                timed = (f"  kernel {res['ms']:.4f} ms  plain {res['plain_ms']:.4f} ms  bound "
                         f"{res['bound_ms'] * 1e3:.2f} us ({res['bound_by']})  SDPA "
                         f"{res['library_ms']:.4f} ms{vs_parent(res)}" if "ms" in res else "")
                log(f"[flash d256] {name} {model} H={h}/{h_kv} (g={g}) {res['dtype']} T={t} "
                    f"({t * g} rows a kv head) S={lim}" + (f" {case}" if case else "")
                    + (f" from q={kw['q0']}" if "q0" in kw else "") + f"{timed}  rel err {rel:.2e}"
                    + (f", masked row = uniform ({rel_u:.1e})" if masked is not None else "")
                    + f"; {plan.body}, rows {plan.rows_per_block}, splits {plan.splits}{reads}")
            del kc, vc
            torch.cuda.empty_cache()
    return out


#: a chat turn's feed at an offset (`Generator._extend`): (T, real rows n,
#: first q position, s_limit); rows n..T-1 are padding (positions past the
#: feed, tags unwritten). The last three are phase chat's feeds (`CHAT_FEEDS`).
CHAT_FEEDS = [(256, 138, 0, 256), (128, 79, 185, 512), (256, 219, 311, 1024)]
OFFSET_FEEDS = [(t, t - 3, q0, lim) for q0, lim in ((300, 512), (700, 1024), (960, 1024))
                for t in (16, 32, 64)] + CHAT_FEEDS
OFFSET_TIMED = [(32, 29, 700, 1024)] + CHAT_FEEDS


def prefill_offset_checks(gen, k_cache, v_cache, layer: int) -> list[dict]:
    """flash_prefill as a chat turn's feed runs it: T = 16, 32 and 64 query
    rows (3 of them padding) at positions from 300, 700 and 960 over the
    tags of the history below them, s_limit 512 or 1024, and phase chat's
    three feeds (T = 256 / 128 / 256 from 0 / 185 / 311, with their padding
    rows), at g = 1 (32 kv heads) and g = 4 (8), against the plain version
    (relative error <= 1e-2); `OFFSET_TIMED` at g = 1 timed (kernel, plain,
    bound, library ms)."""
    import torch
    import torch.nn.functional as F

    from eagle_tpu_torch.ops import flash_attention as fa

    b, h, d, s = k_cache.shape[1], k_cache.shape[2], k_cache.shape[4], k_cache.shape[3]
    caches = {1: (k_cache, v_cache), 4: (k_cache[:, :, :h // 4].contiguous(),
                                         v_cache[:, :, :h // 4].contiguous())}
    out, worst = [], 0.0
    for g, (kc, vc) in caches.items():
        for feed in OFFSET_FEEDS:
            t, n, q0, lim = feed
            slots = torch.arange(s, dtype=torch.int32, device="cuda")[None]
            tags = torch.where(slots < q0 + n, slots, -1)
            q_pos = q0 + torch.arange(t, dtype=torch.int32, device="cuda")[None]
            q = torch.randn((b, t, h, d), generator=gen, device="cuda")
            got = fa.flash_attention_prefill(q, kc, vc, q_pos, tags, layer, s_limit=lim)
            want = fa.flash_attention_prefill_plain(q, kc, vc, q_pos, tags, layer, s_limit=lim)
            torch.cuda.synchronize()
            abs_err, rel = rel_err(got, want)
            plan = fa._plan(t * g, lim, d, torch.bfloat16, b * h // g, True)
            if rel > ATTN_TOL or not bool(torch.isfinite(got).all()):
                raise AssertionError(f"flash_prefill at an offset: T={t} (n={n}) from {q0} "
                                     f"S={lim} g={g} ({plan}): rel err {rel:.3e} > {ATTN_TOL}")
            worst = max(worst, rel)
            if feed in CHAT_FEEDS:
                log(f"[flash_prefill] phase chat's feed T={t} (n={n}) from q={q0} S={lim} g={g}: "
                    f"rel err {rel:.2e}; {plan}")
            if feed not in OFFSET_TIMED or g != 1:
                continue
            reps = 50 if t <= 64 else 20
            ms = device_ms(lambda i: fa.flash_attention_prefill(q, kc, vc, q_pos, tags, layer,
                                                               s_limit=lim), reps)
            plain = device_ms(lambda i: fa.flash_attention_prefill_plain(
                q, kc, vc, q_pos, tags, layer, s_limit=lim), 10)
            vis = (tags[:, None, :lim] >= 0) & (tags[:, None, :lim] <= q_pos[:, :, None])
            qb = q.transpose(1, 2).to(torch.bfloat16)
            kl, vl = kc[layer, :, :, :lim], vc[layer, :, :, :lim]
            lib = device_ms(lambda i: F.scaled_dot_product_attention(
                qb, kl, vl, attn_mask=vis[:, None]), reps)
            b_ms, b_by = prefill_bound(q, kc, q_pos, tags, lim)
            what = "phase chat's feed" if feed in CHAT_FEEDS else "a chat feed at an offset"
            out.append(dict(name="flash_prefill", what=what, t=t, n=n, q0=q0, s=lim, ms=ms,
                            plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=lib,
                            max_abs_err=abs_err, rel_err=rel, plan=plan._asdict()))
            log(f"[flash_prefill] {what}: T={t} ({t - n} padded) from q={q0} S={lim} H={h} "
                f"D={d}  kernel {ms:.4f} ms  plain {plain:.4f} ms  bound {b_ms * 1e3:.2f} us "
                f"({b_by})  library {lib:.4f} ms  rel err {rel:.2e}{vs_parent(out[-1])}")
    log(f"[flash_prefill] feeds at an offset: T 16-64 from q 300 / 700 / 960, S 512 / 1024, "
        f"and phase chat's three, g 1 and 4 ({2 * len(OFFSET_FEEDS)} checks): worst rel err "
        f"{worst:.2e}")
    return out


def gqa_checks(gen) -> list[dict]:
    """Both kernels at g = 4 (32 query heads over 8 kv heads of 128, bf16
    cache, s_limit 300) against their plain versions: T = 6 and 20 give 24
    and 80 rows per kv head, across a 16- and a 64-row tile edge; a row that
    sees nothing comes out as the uniform average of V over [0, 300)."""
    import torch

    from eagle_tpu_torch.ops import flash_attention as fa
    from eagle_tpu_torch.runtime.kvcache import causal_mask_from_tags

    b, h, h_kv, d, s, lim, layer = 1, 32, 8, 128, 512, 300, 0
    k_cache = torch.randn((1, b, h_kv, s, d), generator=gen, device="cuda").to(torch.bfloat16)
    v_cache = torch.randn((1, b, h_kv, s, d), generator=gen, device="cuda").to(torch.bfloat16)
    tags = torch.full((b, s), -1, dtype=torch.int32, device="cuda")
    tags[:, :290] = torch.arange(290, dtype=torch.int32, device="cuda")
    tags[:, 40:44] = -1
    uniform = v_cache[layer, :, :, :lim].float().mean(dim=2).repeat_interleave(h // h_kv, dim=1)
    out = []
    for t in (6, 20):
        pos = (270 + torch.arange(t, dtype=torch.int32, device="cuda"))[None].clone()
        q = torch.randn((b, t, h, d), generator=gen, device="cuda")
        mask = causal_mask_from_tags(tags[:, :lim], pos)
        mask[:, t // 2] = False
        q_pos = pos.clone()
        q_pos[:, t // 2] = -1
        for name, got, want in (
                ("flash_decode", fa.flash_attention_cached(q, k_cache, v_cache, mask, layer,
                                                           s_limit=lim),
                 fa.flash_attention_cached_plain(q, k_cache, v_cache, mask, layer, s_limit=lim)),
                ("flash_prefill", fa.flash_attention_prefill(q, k_cache, v_cache, q_pos, tags,
                                                             layer, s_limit=lim),
                 fa.flash_attention_prefill_plain(q, k_cache, v_cache, q_pos, tags, layer,
                                                  s_limit=lim))):
            torch.cuda.synchronize()
            abs_err, rel = rel_err(got, want)
            _, rel_u = rel_err(got[:, t // 2], uniform)
            if rel > ATTN_TOL or rel_u > ATTN_TOL or not bool(torch.isfinite(got).all()):
                raise AssertionError(f"{name} g=4 T={t} s_limit={lim}: rel err {rel:.3e}, "
                                     f"masked row {rel_u:.3e}")
            plan = fa._plan(t * h // h_kv, lim, d, torch.bfloat16, b * h_kv, name == "flash_prefill")
            log(f"[{name}] g=4 T={t} ({t * h // h_kv} rows per kv head) S={lim}: rel err "
                f"{rel:.2e}, masked row = uniform average ({rel_u:.1e}); {plan}")
            out.append(dict(name=name, g=4, t=t, s=lim, max_abs_err=abs_err, rel_err=rel,
                            plan=plan._asdict()))
    return out


def tiny_model_check() -> dict:
    """A 2-layer model's logits through the kernels on the card against the
    plain path on the CPU, same weights, f32 compute and cache. Every qmm of
    an f32 forward takes the SIMT body: returns the launch counts of the
    card's forward, counted from zero."""
    import torch

    from eagle_tpu_torch import _build
    from eagle_tpu_torch.models.config import ModelConfig
    from eagle_tpu_torch.models.llama import llama_forward
    from eagle_tpu_torch.models.synth import synth_llama_params
    from eagle_tpu_torch.quant.qtensor import QTensor
    from eagle_tpu_torch.runtime.kvcache import KVCache, causal_mask_from_tags

    cfg = ModelConfig(vocab_size=512, n_embd=256, n_layers=2, n_heads=4, n_kv_heads=2,
                      head_dim=64, n_ff=512, rms_eps=1e-6, rope_dim=64)
    params = synth_llama_params(cfg, seed=3, packed=True, coded=True, device="cuda")

    def to_cpu(tree):
        if isinstance(tree, dict):
            return {k: to_cpu(v) for k, v in tree.items()}
        if isinstance(tree, QTensor):
            return dataclasses.replace(tree, **{k: None if v is None else v.cpu()
                                                for k, v in tree.tensors().items()})
        return tree.cpu()

    cpu_params = to_cpu(params)
    toks = torch.randint(0, 512, (1, 20), generator=torch.Generator().manual_seed(0))
    outs = []
    _build.reset_counts()  # ---- the card's f32 forward: counts from here ----
    for dev, p in (("cuda", params), ("cpu", cpu_params)):
        kv = KVCache.create(2, 1, 128, 2, 64, torch.float32, device=dev)
        logits = []
        for lo, hi, tags_prefill in ((0, 16, True), (16, 17, False), (17, 20, False)):
            pos = torch.arange(lo, hi, dtype=torch.int32, device=dev)[None]
            kv.with_tags(pos, pos)
            mask = causal_mask_from_tags(kv.slot_pos, pos)
            fo = llama_forward(p, cfg, toks[:, lo:hi].to(dev), pos, kv, pos, mask,
                               compute_dtype=torch.float32, kv_limit=128,
                               causal_tags_prefill=tags_prefill)
            logits.append(fo.logits.cpu())
        outs.append(torch.cat(logits, dim=1))
        if dev == "cuda":
            launches = dict(_build.launches)  # ---- ends ----
    _, rel = rel_err(outs[0], outs[1])
    if rel > TINY_TOL:
        raise AssertionError(f"tiny model: card vs CPU rel err {rel:.3e} > {TINY_TOL}")
    log(f"[tiny] 2-layer model logits, kernels on the card vs plain on the CPU: rel err {rel:.2e}; "
        f"launches {launches}")
    if launches["qmm"] <= 0 or launches["qmm_gemv"] or launches["qmm_mma"] or launches["qmm_tc"]:
        raise AssertionError(f"tiny f32 model: qmm took another body than SIMT: {launches}")
    return launches


# --------------------------------------------------------------------------
# phases 3-5


#: kernels that every main path runs (the SIMT qmm body left them: phase 2's
#: f32 model and ragged shapes hold its launches)
CORE_KERNELS = ("qmm_gemv", "qmm_tc", "qmm_mma", "flash_decode", "flash_prefill")
PROMPT_QMM = 32 * 4 + 1  # a prompt's 512-row products: 4 per layer and lm_head
DECODE_QMM = 32 * 4 + 1  # a decoded token's 1-row products, unfused
DECODE_QMM_FUSED = 32 * 2 + 1  # with the fused FFN block: wqkv, w_down, lm_head
VERIFY_QMM = 32 * 4 + 1  # a verify forward's 6-row products, unfused
VERIFY_QMM_FUSED = 32 * 2 + 1  # with the fused FFN block: wqkv, w_down, lm_head


def timed_run(run):
    """run(on_token) -> (result, TTFT s, seconds after the first token,
    launch counts at the first token, ms the host spent in Python's garbage
    collector during the run)."""
    import gc

    import torch

    from eagle_tpu_torch import _build

    marks = {"gc_ms": 0.0}

    def on_token(_):
        if "first" not in marks:
            torch.cuda.synchronize()
            marks["first"] = time.perf_counter()
            marks["counts"] = dict(_build.launches)

    def on_gc(phase, _info):
        if phase == "start":
            marks["gc_start"] = time.perf_counter()
        elif "gc_start" in marks:
            marks["gc_ms"] += (time.perf_counter() - marks.pop("gc_start")) * 1e3

    torch.cuda.synchronize()
    gc.callbacks.append(on_gc)
    try:
        start = time.perf_counter()
        result = run(on_token)
        torch.cuda.synchronize()
        end = time.perf_counter()
    finally:
        gc.callbacks.remove(on_gc)
    return (result, marks["first"] - start, end - marks["first"], marks["counts"],
            marks["gc_ms"])


def check_near_tie(gen, prompt, want: list, got: list, tag: str, what: str) -> dict | None:
    """Where two greedy token streams first differ, the target's top-2 logit
    margin there (full prefill of the common prefix) must be within 1e-2 of
    the logit range: a bf16 near-tie, not a divergence."""
    res = first_divergence(gen, prompt, want, got, tag, what)
    if res is not None and res["margin"] > 1e-2 * res["logit_range"]:
        raise AssertionError(f"{what}: tokens diverge beyond a bf16 near-tie")
    return res


def first_divergence(gen, prompt, want: list, got: list, tag: str, what: str) -> dict | None:
    """The step where two greedy token streams first differ and the target's
    top-2 logit margin there (full prefill of the common prefix), logged;
    None when they are identical."""
    import numpy as np
    import torch

    diverged = next((i for i, (a, b) in enumerate(zip(want, got)) if a != b), None)
    if diverged is None:
        log(f"[{tag}] {what}: tokens identical ({len(got)} tokens)")
        return None
    seq = list(prompt) + want[:diverged]
    t = 1024 if len(seq) > 512 else 512
    padded = np.zeros((1, t), np.int32)
    padded[0, : len(seq)] = seq
    lg, _, _ = gen._prefill(torch.from_numpy(padded).cuda(),
                            torch.tensor([len(seq)], dtype=torch.int32, device="cuda"), t)
    top2 = torch.topk(lg[0].float(), 2).values
    margin = float(top2[0] - top2[1])
    rng = float(lg.max() - lg.min())
    log(f"[{tag}] {what}: tokens differ first at step {diverged}: target top-2 margin "
        f"{margin:.4e}, logit range {rng:.4e}")
    return dict(step=diverged, margin=margin, logit_range=rng)


def profile_steps(run, n: int, what: str, unit: str, tag: str = "profile") -> dict:
    """Time `run()` (n eager steps or cycles, warmed by the caller) on the
    host clock, then trace it again with torch.profiler: device busy share
    of the (unprofiled) wall time and the kernels that take the device
    time, per `unit`."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    rows = [(device_us(e), e.key, e.count) for e in prof.key_averages() if device_us(e) > 0]
    rows.sort(reverse=True)
    busy_us = sum(r[0] for r in rows)
    n_kernels = sum(r[2] for r in rows) / n
    if busy_us == 0:
        log(f"[{tag}] torch.profiler saw no device time: device busy share not measured")
        return {f"wall_ms_per_{unit}": wall_us / n / 1e3, f"device_ms_per_{unit}": None}
    log(f"[{tag}] {n} {what}: wall {wall_us / n / 1e3:.3f} ms/{unit}, device busy "
        f"{busy_us / n / 1e3:.3f} ms/{unit} ({100 * busy_us / wall_us:.1f}% of wall, idle "
        f"{100 - 100 * busy_us / wall_us:.1f}%), {n_kernels:.0f} device kernels/{unit}")
    top = []
    for dev, key, count in rows[:8]:
        log(f"[{tag}]   {dev / n / 1e3:8.3f} ms/{unit}  {count // n:5d} calls/{unit}  {key[:90]}")
        top.append({"kernel": key, f"ms_per_{unit}": dev / n / 1e3, f"calls_per_{unit}": count / n})
    return {f"wall_ms_per_{unit}": wall_us / n / 1e3, f"device_ms_per_{unit}": busy_us / n / 1e3,
            "idle_share": 1 - busy_us / wall_us, f"kernels_per_{unit}": n_kernels, "top": top}


def profile_decode(gen, token: int, pos: int, steps: int = 8) -> dict:
    """`profile_steps` over `steps` eager greedy decode steps."""
    import torch

    from eagle_tpu_torch.runtime.sampling import SamplerConfig

    tok = torch.tensor([token], dtype=torch.int32, device="cuda")
    scfg = SamplerConfig(greedy=True)
    limit = gen.kv_read_bucket(pos + steps)
    gen._decode_chunk(tok, pos, scfg, 2, kv_limit=limit)  # warm
    return profile_steps(lambda: gen._decode_chunk(tok, pos, scfg, steps, kv_limit=limit),
                         steps, "decode steps", "token")


def profile_cycles(eng, prompt, tag: str, cycles: int = 4) -> dict:
    """`profile_steps` over `cycles` eager cycles of `eng` from a fresh
    prompt, all at one read bucket, which the last cycle's window must fit
    below."""
    eng.generate(prompt, max_new_tokens=1)
    lim = eng.kv_read_bucket(int(eng.state.n_past[0]) + cycles * (eng.K + 2))
    eng._multi_cycle(1, kv_limit=lim)  # warm
    out = profile_steps(lambda: [eng._multi_cycle(1, kv_limit=lim) for _ in range(cycles)],
                        cycles, "eager cycles", "cycle", tag)
    check_window(eng, 1, lim)
    return out


#: timed runs of each variant: min / median / max, the host's spread; two,
#: not three, keep the script in its time budget
REPS = 2
#: an eager variant runs once: it holds the graphed runs' tokens, and no user
#: path runs eagerly (it kept the script's time within its budget)
EAGER_REPS = 1
#: (name, graphed, cycles per dispatch; None for greedy); the first two are
#: the user's default path (graphs on, C = 1), counted together
VARIANTS = (("greedy graphed", True, None), ("eagle graphed C=1", True, 1),
            ("greedy eager", False, None), ("eagle eager C=1", False, 1),
            ("eagle graphed C=4", True, 4))


def spread(xs: list) -> dict:
    s, n = sorted(xs), len(xs)
    return {"min": s[0], "median": (s[(n - 1) // 2] + s[n // 2]) / 2, "max": s[-1],
            "in_run_order": xs}


def fmt(s: dict, digits: int = 2) -> str:
    return f"{s['min']:.{digits}f} / {s['median']:.{digits}f} / {s['max']:.{digits}f}"


class CardSampler:
    """The card's SM and memory clocks (MHz), power draw (W) and temperature
    (C), sampled by `nvidia-smi -lms 100` while the block runs: the clocks
    and power beside a timed window. The process is stopped on exit."""

    FIELDS = ("clocks.sm", "clocks.mem", "power.draw", "temperature.gpu")

    def __enter__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", f"--query-gpu={','.join(self.FIELDS)}",
             "--format=csv,noheader,nounits", "-lms", "100"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        out, _ = self.proc.communicate(timeout=30)
        rows = []
        for line in out.splitlines():
            try:
                rows.append([float(v) for v in line.split(",")])
            except ValueError:  # a field the card does not report
                continue
        self.summary = ({f: [min(r[i] for r in rows), max(r[i] for r in rows)]
                         for i, f in enumerate(self.FIELDS)} if rows else None)
        return False

    def line(self) -> str:
        if not self.summary:
            return "clocks and power not measured"
        s = self.summary
        return (f"SM clock {s['clocks.sm'][0]:.0f}-{s['clocks.sm'][1]:.0f} MHz, memory clock "
                f"{s['clocks.mem'][0]:.0f}-{s['clocks.mem'][1]:.0f} MHz, power "
                f"{s['power.draw'][0]:.0f}-{s['power.draw'][1]:.0f} W, "
                f"{s['temperature.gpu'][0]:.0f}-{s['temperature.gpu'][1]:.0f} C")


def timed_events(fn, n: int) -> dict:
    """CUDA events around `fn()` (n steps or cycles of enqueued work): device
    ms per step (`ms`), and the host's ms per step until `fn` returned
    (`enqueue_ms`) and until the work ended (`wall_ms`)."""
    import torch

    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    fn()
    enqueued = time.perf_counter()
    end.record()
    end.synchronize()
    return {"ms": start.elapsed_time(end) / n, "enqueue_ms": (enqueued - t0) * 1e3 / n,
            "wall_ms": (time.perf_counter() - t0) * 1e3 / n}


def cycle_device_ms(eng, prompt, c: int, cycles: int = 8) -> dict:
    """`timed_events` over `cycles` graphed cycles of `eng` at C = c cycles
    per dispatch, from a fresh prompt, at the read bucket `generate` takes
    for the first dispatch (warmed by the caller); the last cycle's window
    must fit below it."""
    eng.generate(prompt, max_new_tokens=1)  # the state reset, the prompt's first token
    n_past = int(eng.state.n_past[0])
    lim = eng.kv_read_bucket(n_past + c * (eng.K + 2))
    out = timed_events(lambda: [eng._multi_cycle(c, kv_limit=lim) for _ in range(cycles // c)],
                       cycles)
    check_window(eng, c, lim)
    return out


def check_window(eng, c: int, lim: int) -> None:
    """The last cycle run at C = c read its whole window below `lim`."""
    last_start = int(eng.state.n_past[0]) - int(eng._outs[c].n_out[-1, 0])
    if last_start + eng.K + 2 > lim:
        raise AssertionError("the cycles left the read bucket")


def graphed_device_ms(gen, eng, prompt, token: int, pos: int, steps: int = 16,
                      cycles: int = 8) -> dict:
    """Device ms of the graphed bodies: CUDA events around back-to-back
    replays of a decode step (`steps` of them from `pos`, in `windows`
    windows; the median window is `step_ms`), and of an EAGLE cycle at 1
    and 4 cycles per dispatch (`cycles` each, from a fresh prompt). The
    events bracket the card's work, the gaps between a graph's kernels
    included, as long as the host enqueues ahead of the card: beside them
    the host's time until the replays were enqueued and until they ended,
    and one step's enqueue after a synchronize. No body may run eagerly
    here (every graph is warm)."""
    import torch

    from eagle_tpu_torch.runtime.sampling import SamplerConfig

    def events(name, fn, n):
        out.update({f"{name}_{k}": v for k, v in timed_events(fn, n).items()})

    eager = gen.graphs.eager, eng.graphs.eager
    tok = torch.tensor([token], dtype=torch.int32, device="cuda")
    scfg = SamplerConfig(greedy=True)
    limit = gen.kv_read_bucket(pos + steps)
    out: dict = {}
    windows = {"step_ms": [], "step_enqueue_ms": [], "step_wall_ms": []}
    for _ in range(5):
        events("step", lambda: gen._decode_chunk(tok, pos, scfg, steps, kv_limit=limit), steps)
        for k in windows:
            windows[k].append(out[k])
    out.update({k: sorted(v)[len(v) // 2] for k, v in windows.items()})
    out["step_windows"] = windows
    launch = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gen._decode_chunk(tok, pos, scfg, 1, kv_limit=limit)
        launch.append((time.perf_counter() - t0) * 1e3)
    out["step_launch_ms"] = min(launch)
    for c in (1, 4):
        out.update({f"cycle_c{c}_{k}": v
                    for k, v in cycle_device_ms(eng, prompt, c, cycles).items()})
    if (gen.graphs.eager, eng.graphs.eager) != eager:
        raise AssertionError("a body ran eagerly while the graphs were timed")
    return out


def serve_cell(tag: str, params, draft, cfg, dcfg, prompt, n_new: int, want_tok: dict,
               per_cycle: int, fused: bool, kernels: tuple = CORE_KERNELS) -> dict:
    """Greedy and the EAGLE chain engine (K = 5) on one model, eager and
    graphed, each variant of VARIANTS timed REPS times. Every run's launch
    counts are read from zero: per greedily decoded token they must equal
    `want_tok`, per EAGLE cycle computed `per_cycle` qmm_mma, each of
    `kernels` runs on the default path, and no plain version runs.
    Graphed tokens must equal eager tokens bit for bit, and no step or
    cycle of a graphed engine may run eagerly after its warm-up."""
    import torch

    from eagle_tpu_torch import _build
    from eagle_tpu_torch.runtime.generate import Generator
    from eagle_tpu_torch.runtime.speculative import EagleChainEngine

    gens = {g: Generator(params, cfg, max_seq=1024, batch=1, kv_dtype=torch.bfloat16,
                         compute_dtype=torch.bfloat16, eos_id=-1, cuda_graphs=g)
            for g in (False, True)}
    engs = {g: EagleChainEngine(params, draft, cfg, dcfg, n_draft=5, max_seq=1024,
                                kv_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
                                eos_id=-1, cuda_graphs=g)
            for g in (False, True)}
    gens[False].generate(prompt[:40], max_new_tokens=4, stop_at_eos=False)  # warm-up
    engs[False].generate(prompt[:40], max_new_tokens=4, stop_at_eos=False)
    # the graphed engines' warm-up: each step and dispatch graph this cell
    # replays is captured here, at the runs' own buckets
    torch.cuda.synchronize()
    torch.cuda.empty_cache()  # capture empties the cache too: count only what stays
    reserved = torch.cuda.memory_reserved()
    gens[True].generate(prompt, max_new_tokens=n_new, stop_at_eos=False)
    for c in (1, 4):
        engs[True].generate(prompt, max_new_tokens=n_new, stop_at_eos=False,
                            cycles_per_dispatch=c)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    graph_mib = (torch.cuda.memory_reserved() - reserved) / 2**20
    warm = {"greedy": gens[True].graphs.eager, "eagle": engs[True].graphs.eager}
    log(f"[{tag}] graphs captured in the warm-up: greedy {gens[True].graphs.captures}, "
        f"EAGLE {engs[True].graphs.captures} (1 and 4 cycles per dispatch); device memory "
        f"reserved by the warm-up (graph pools, output buffers): {graph_mib:.1f} MiB")

    res: dict = {v[0]: {"ttft_ms": [], "tokens_per_s": [], "wall_ms_per_step": [], "gc_ms": []}
                 for v in VARIANTS}
    tokens: dict = {}
    sampler = CardSampler()
    with sampler:  # clocks and power beside the timed runs
        for rep in range(REPS):
            for name, graphed, cycles in VARIANTS:
                if not graphed and rep >= EAGER_REPS:
                    continue
                if name != "eagle graphed C=1":  # the default path's two runs count together
                    _build.reset_counts()
                before = dict(_build.launches)
                if cycles is None:
                    gen = gens[graphed]
                    toks, ttft, t_dec, at_first, gc_ms = timed_run(
                        lambda cb: gen.generate(prompt, max_new_tokens=n_new, stop_at_eos=False,
                                                on_token=cb))
                    n_dec = len(toks) - 1
                    per_token = {k: (_build.launches[k] - at_first[k]) / n_dec
                                 for k in _build.launches}
                    if any(per_token[k] != v for k, v in want_tok.items()):
                        raise AssertionError(f"{tag} {name}: launches per decoded token "
                                             f"{per_token}, expected {want_tok}")
                    steps, stats = n_dec, None
                    if rep == 0:
                        res[name].update(launches_per_decoded_token=per_token,
                                         launches_at_first_token=at_first)
                else:
                    eng = engs[graphed]
                    run0 = eng.cycles_run
                    (toks, stats), ttft, t_dec, _, gc_ms = timed_run(
                        lambda cb: eng.generate(prompt, max_new_tokens=n_new, stop_at_eos=False,
                                                on_token=cb, cycles_per_dispatch=cycles))
                    steps = eng.cycles_run - run0  # cycles computed, overshoot included
                    mma = _build.launches["qmm_mma"] - before["qmm_mma"]
                    if mma != per_cycle * steps:
                        raise AssertionError(f"{tag} {name}: {mma} qmm_mma launches in {steps} "
                                             f"cycles, expected {per_cycle} each")
                    if rep == 0:
                        res[name].update(stats=stats, cycles_run=steps,
                                         qmm_mma_per_cycle=mma / steps)
                if any(_build.plain_calls.values()):
                    raise AssertionError(f"{tag} {name}: plain versions ran: {_build.plain_calls}")
                if len(toks) != n_new:
                    raise AssertionError(f"{tag} {name}: {len(toks)} tokens, expected {n_new}")
                res[name]["ttft_ms"].append(ttft * 1e3)
                res[name]["tokens_per_s"].append((len(toks) - 1) / t_dec)
                res[name]["wall_ms_per_step"].append(t_dec / steps * 1e3)
                res[name]["gc_ms"].append(gc_ms)
                if rep == 0:
                    res[name]["launches"] = dict(_build.launches)
                kind = "greedy" if cycles is None else "eagle"
                if tokens.setdefault(kind, toks) != toks:
                    raise AssertionError(f"{tag} {name} (run {rep}): tokens differ from the "
                                         f"{kind} run before, bit for bit")
    eager_after = {"greedy": gens[True].graphs.eager - warm["greedy"],
                   "eagle": engs[True].graphs.eager - warm["eagle"]}
    log(f"[{tag}] graphed tokens == eager tokens, bit for bit: greedy ({n_new}) and EAGLE "
        f"C=1 and C=4 ({n_new}), {REPS} runs each; eager bodies after the warm-up: "
        f"{eager_after} (replays: greedy {gens[True].graphs.replays}, EAGLE "
        f"{engs[True].graphs.replays})")
    if any(eager_after.values()):
        raise AssertionError(f"{tag}: a graphed engine ran a body eagerly: {eager_after}")
    main = res["eagle graphed C=1"]["launches"]  # the default path: greedy + EAGLE, graphed
    for k in kernels:
        if main[k] <= 0:
            raise AssertionError(f"{tag}: kernel {k} was not launched on the default path")
    if (main["ffn_out_norm"] > 0 and main["gate_up_act"] > 0) != fused or (
            not fused and main["ffn_out_norm"]):
        raise AssertionError(f"{tag}: fused FFN launches {main} with fused={fused}")

    for name, _, cycles in VARIANTS:
        r = res[name]
        for key in ("ttft_ms", "tokens_per_s", "wall_ms_per_step"):
            r[key] = spread(r[key])
        extra = ""
        if cycles:
            st = r["stats"]
            extra = (f", mean_accept_len {st['mean_accept_len']:.3f}, accept_rate "
                     f"{st['accept_rate']:.3f}, {st['n_cycles']} cycles ({r['cycles_run']} "
                     f"computed), qmm_mma {r['qmm_mma_per_cycle']:.0f} per cycle")
        order = ", ".join(f"{v:.2f}" for v in r["tokens_per_s"]["in_run_order"])
        extra += (", Python's garbage collector " + " / ".join(f"{v:.1f}" for v in r["gc_ms"])
                  + " ms (in run order)")
        log(f"[{tag}] {name}: tokens/s min / median / max {fmt(r['tokens_per_s'])} ({order} "
            f"in run order), TTFT ms "
            f"{fmt(r['ttft_ms'], 1)}, wall ms per {'token' if cycles is None else 'cycle'} "
            f"{fmt(r['wall_ms_per_step'])}{extra}")
    per_token = res["greedy graphed"]["launches_per_decoded_token"]
    log(f"[{tag}] launches per decoded token (graphed, replays counted): "
        + ", ".join(f"{k} {per_token[k]:.1f}" for k in dict.fromkeys((*want_tok,
                                                                       "flash_decode"))))

    greedy = tokens["greedy"]
    dev = graphed_device_ms(gens[True], engs[True], prompt, greedy[-1], len(prompt) + n_new - 1)
    wall_tok = res["greedy graphed"]["wall_ms_per_step"]["median"]
    wall_cyc = {c: res[f"eagle graphed C={c}"]["wall_ms_per_step"]["median"] for c in (1, 4)}
    # idle: 1 - device / wall of the median timed run (the device time comes
    # from the replays above, so within about 1 % of noise it may read < 0)
    dev["idle_share_decode"] = 1 - dev["step_ms"] / wall_tok
    for c in (1, 4):
        dev[f"idle_share_eagle_c{c}"] = 1 - dev[f"cycle_c{c}_ms"] / wall_cyc[c]
    log(f"[{tag}] graphed decode step: device {dev['step_ms']:.3f} ms/token (CUDA events over "
        f"16 replays; host wall {dev['step_wall_ms']:.3f}), wall {wall_tok:.3f} ms/token "
        f"(median run), idle {100 * dev['idle_share_decode']:.1f}%; EAGLE cycle: device "
        f"{dev['cycle_c1_ms']:.3f} ms (C=1) / {dev['cycle_c4_ms']:.3f} ms (C=4) (host wall "
        f"{dev['cycle_c1_wall_ms']:.3f} / {dev['cycle_c4_wall_ms']:.3f}), wall "
        f"{wall_cyc[1]:.3f} / {wall_cyc[4]:.3f} ms (median runs), idle "
        f"{100 * dev['idle_share_eagle_c1']:.1f}% / {100 * dev['idle_share_eagle_c4']:.1f}%")
    w = dev["step_windows"]
    log(f"[{tag}] graphed step, 5 windows of 16 replays: device "
        + " / ".join(f"{v:.3f}" for v in w["step_ms"]) + " ms, host enqueued after "
        + " / ".join(f"{v:.3f}" for v in w["step_enqueue_ms"]) + " ms, ended after "
        + " / ".join(f"{v:.3f}" for v in w["step_wall_ms"])
        + f" ms per step; one step enqueued in {dev['step_launch_ms']:.3f} ms after a "
        f"synchronize (min of 5)")
    log(f"[{tag}] the card over the timed runs: {sampler.line()}")
    return dict(variants=res, graphed_device=dev, graph_warmup_mib=graph_mib,
                card_during_runs=sampler.summary,
                greedy_tokens=greedy,
                eagle_tokens=tokens["eagle"], eager_after_warmup=eager_after,
                eagle_vs_greedy=check_near_tie(gens[False], prompt, greedy, tokens["eagle"],
                                               tag, "EAGLE vs greedy"),
                eager_decode_profile=profile_decode(gens[False], greedy[-1],
                                                    len(prompt) + n_new - 1),
                gen=gens[False])


# --------------------------------------------------------------------------
# the tree engines (runtime/tree.py, runtime/tree2.py)


def tree_engine(kind: str, params, draft, cfg, dcfg, graphed: bool):
    """The reference's default static tree (TreeSpec((4, 2, 2)): 29 verify
    rows) or EAGLE-2 engine (beam 8, depth 6, 32 verify rows), bf16."""
    import torch

    from eagle_tpu_torch.runtime.tree import EagleTreeEngine, TreeSpec
    from eagle_tpu_torch.runtime.tree2 import EagleTree2Engine

    kw = dict(max_seq=1024, kv_dtype=torch.bfloat16, compute_dtype=torch.bfloat16, eos_id=-1,
              cuda_graphs=graphed)
    if kind == "tree":
        return EagleTreeEngine(params, draft, cfg, dcfg, tree=TreeSpec(TREE_SPEC), **kw)
    return EagleTree2Engine(params, draft, cfg, dcfg, **TREE2, **kw)


def tree_cycle_launches(eng, fused: bool, draft_fused: bool) -> dict:
    """Launches per computed cycle, derived from the code: the verify
    forward over N > 8 rows (32 layers of 4 products, or 2 with the fused
    FFN block, + lm_head, all on the wgmma body: qmm_tc; 32 flash_decode; 32
    of each fused kernel when fused) and one draft forward per drafted level
    of L rows (fc, the layer's 4 products or 2 fused, lm_head: qmm_gemv at 1
    row, qmm_mma at 2-8 rows; one flash_decode; one of each fused kernel
    when the draft's layer takes the fused block). The static tree drafts
    levels of 1, 4 and 8 nodes; EAGLE-2 the root and D - 1 levels of M."""
    levels = ([len(lv) for lv in eng.tree.levels[:-1]] if hasattr(eng, "tree")
              else [1] + [eng.M] * (eng.D - 1))
    want = {"qmm_tc": 32 * (2 if fused else 4) + 1, "qmm_gemv": 0, "qmm_mma": 0, "qmm": 0,
            "flash_decode": 32 + len(levels), "flash_prefill": 0,
            "ffn_out_norm": 32 * fused, "gate_up_act": 32 * fused}
    for rows in levels:
        want["qmm_gemv" if rows == 1 else "qmm_mma"] += 2 + (2 if draft_fused else 4)
        want["ffn_out_norm"] += draft_fused
        want["gate_up_act"] += draft_fused
    return want


def oracle_forward(real, seq):
    """`eagle_forward` with 1e4 added to its logits at the target's greedy
    continuation, read from the device tensor `seq` (prompt + greedy
    tokens): the pair at draft position p proposes x_{p+2}. No host read,
    so a graph captures it; there are no ties with the boost."""
    import torch

    def forward(*args, **kw):
        out = real(*args, **kw)
        if out.logits is None:  # the prompt's draft pass
            return out
        want = seq[(args[5].long() + 2).clamp(max=seq.numel() - 1)]  # [B, T]
        boosted = out.logits.scatter_add(-1, want[..., None],
                                         torch.full_like(out.logits[..., :1], 1e4))
        return out._replace(logits=boosted)

    return forward


def tree_cell(tag: str, params, draft, cfg, dcfg, prompt, n_new: int, greedy: list, gen,
              variants, fused: bool, draft_fused: bool) -> dict:
    """The tree engines on one model: each (kind, graphed, C) of `variants`
    timed REPS times after the warm-up (every graph captured at the runs'
    buckets). Every run's launch counts are read from zero: per computed
    cycle they must equal `tree_cycle_launches`, and no plain version runs.
    Graphed tokens must equal eager tokens bit for bit, no cycle of a
    graphed engine may run eagerly after its warm-up, and the tokens equal
    greedy's up to a bf16 near-tie. Per variant: tokens/s, TTFT, wall ms per
    cycle, mean_accept_len; per graphed variant the device ms per cycle
    (CUDA events over 8 replayed cycles) and the idle share."""
    import torch

    from eagle_tpu_torch import _build

    engs = {}
    for kind, graphed, _ in variants:
        if (kind, graphed) not in engs:
            engs[(kind, graphed)] = tree_engine(kind, params, draft, cfg, dcfg, graphed)
    for (kind, graphed), eng in engs.items():
        if not graphed:
            eng.generate(prompt[:40], max_new_tokens=4, stop_at_eos=False)
    for kind, graphed, c in variants:
        if graphed:
            engs[(kind, True)].generate(prompt, max_new_tokens=n_new, stop_at_eos=False,
                                        cycles_per_dispatch=c)
    warm = {k: e.graphs.eager for k, e in engs.items() if k[1]}
    res: dict = {}
    tokens: dict = {}
    sampler = CardSampler()
    with sampler:
        for rep in range(REPS):
            for kind, graphed, c in variants:
                if not graphed and rep >= EAGER_REPS:
                    continue
                name = f"{kind} {'graphed' if graphed else 'eager'} C={c}"
                eng = engs[(kind, graphed)]
                want = tree_cycle_launches(eng, fused, draft_fused)
                r = res.setdefault(name, {"tokens_per_s": [], "ttft_ms": [],
                                          "wall_ms_per_cycle": []})
                run0 = eng.cycles_run
                _build.reset_counts()
                (toks, stats), ttft, t_dec, at_first, _ = timed_run(
                    lambda cb: eng.generate(prompt, max_new_tokens=n_new, stop_at_eos=False,
                                            on_token=cb, cycles_per_dispatch=c))
                cycles = eng.cycles_run - run0
                per_cycle = {k: (_build.launches[k] - at_first[k]) / cycles for k in want}
                if per_cycle != want:
                    raise AssertionError(f"{tag} {name}: launches per cycle {per_cycle}, "
                                         f"expected {want}")
                if any(_build.plain_calls.values()):
                    raise AssertionError(f"{tag} {name}: plain versions ran: {_build.plain_calls}")
                if len(toks) != n_new:
                    raise AssertionError(f"{tag} {name}: {len(toks)} tokens, expected {n_new}")
                if tokens.setdefault(kind, toks) != toks:
                    raise AssertionError(f"{tag} {name} (run {rep}): tokens differ from the "
                                         f"{kind} run before, bit for bit")
                r["tokens_per_s"].append((len(toks) - 1) / t_dec)
                r["ttft_ms"].append(ttft * 1e3)
                r["wall_ms_per_cycle"].append(t_dec / cycles * 1e3)
                if rep == 0:
                    r.update(stats=stats, cycles_run=cycles, launches_per_cycle=per_cycle,
                             launches=dict(_build.launches))
    eager_after = {f"{k[0]} graphed": e.graphs.eager - warm[k] for k, e in engs.items() if k[1]}
    if any(eager_after.values()):
        raise AssertionError(f"{tag}: a graphed tree engine ran a cycle eagerly: {eager_after}")
    for name, r in res.items():
        missing = [k for k in ("qmm_gemv", "qmm_mma", "qmm_tc", "flash_decode")
                   if r["launches"][k] <= 0]
        if missing:
            raise AssertionError(f"{tag} {name}: kernels {missing} were not launched")
    for kind, graphed, c in variants:
        if graphed:
            res[f"{kind} graphed C={c}"]["device"] = cycle_device_ms(engs[(kind, True)], prompt, c)
    if any(e.graphs.eager != warm[k] for k, e in engs.items() if k[1]):
        raise AssertionError(f"{tag}: a tree cycle ran eagerly while the graphs were timed")
    for name, r in res.items():
        for key in ("tokens_per_s", "ttft_ms", "wall_ms_per_cycle"):
            r[key] = spread(r[key])
        st = r["stats"]
        dev = ""
        if "device" in r:
            r["idle_share"] = 1 - r["device"]["ms"] / r["wall_ms_per_cycle"]["median"]
            dev = (f", device {r['device']['ms']:.3f} ms per cycle (CUDA events over 8 replayed "
                   f"cycles), idle {100 * r['idle_share']:.1f}%")
        log(f"[{tag}] {name}: tokens/s min / median / max {fmt(r['tokens_per_s'])}, TTFT ms "
            f"{fmt(r['ttft_ms'], 1)}, wall ms per cycle {fmt(r['wall_ms_per_cycle'])}{dev}, "
            f"mean_accept_len {st['mean_accept_len']:.3f}, {st['n_cycles']} cycles "
            f"({r['cycles_run']} computed)")
    for kind in tokens:
        name = next(n for n in res if n.startswith(kind))
        log(f"[{tag}] {kind} launches per computed cycle (derived from the code, asserted in "
            f"every run): " + ", ".join(f"{k} {v:.0f}" for k, v in
                                        res[name]["launches_per_cycle"].items() if v))
    log(f"[{tag}] graphed tree tokens == eager tokens, bit for bit, {REPS} runs each; eager "
        f"cycles after the warm-up: {eager_after}; the card over the timed runs: {sampler.line()}")
    profiles = {kind: profile_cycles(eng, prompt, f"{tag} {kind} eager profile")
                for (kind, graphed), eng in engs.items() if not graphed}
    vs_greedy = {kind: check_near_tie(gen, prompt, greedy, toks, tag, f"{kind} vs greedy")
                 for kind, toks in tokens.items()}
    del engs
    torch.cuda.empty_cache()
    return dict(variants=res, tokens=tokens, vs_greedy=vs_greedy, eager_after_warmup=eager_after,
                card_during_runs=sampler.summary, eager_cycle_profiles=profiles)


def oracle_runs(tag: str, params, draft, cfg, dcfg, prompt, n_new: int, greedy: list, gen,
                oracle_seq: list) -> dict:
    """Each tree engine, graphed at C = 1, with `oracle_forward` in place of
    its draft forward: every drafted path holds the target's greedy
    continuation, so every cycle must accept the full depth (cycles wholly
    before a bf16 near-tie divergence from greedy, if one shows). This is
    the only run on the card that compacts accepted rows and hands the
    feature on past the root. Its tokens/s is an upper bound, not a result."""
    import torch

    from eagle_tpu_torch.runtime import tree, tree2

    seq = torch.tensor(list(prompt) + list(oracle_seq), dtype=torch.int64, device="cuda")
    out = {}
    for kind, mod in (("tree", tree), ("tree2", tree2)):
        real = mod.eagle_forward
        mod.eagle_forward = oracle_forward(real, seq)
        try:
            eng = tree_engine(kind, params, draft, cfg, dcfg, graphed=True)
            eng.generate(prompt, max_new_tokens=n_new, stop_at_eos=False)  # captures
            warm = eng.graphs.eager
            tps, runs = [], []
            for _ in range(REPS):
                run, _, t_dec, _, _ = timed_run(
                    lambda cb: eng.generate(prompt, max_new_tokens=n_new, stop_at_eos=False,
                                            on_token=cb))
                tps.append((len(run[0]) - 1) / t_dec)
                runs.append(run)
        finally:
            mod.eagle_forward = real
        depth = eng.out_width - 1
        toks, stats = runs[0]
        if eng.graphs.eager != warm or any(r != runs[0] for r in runs):
            raise AssertionError(f"{tag} oracle {kind}: a cycle ran eagerly after the warm-up, "
                                 f"or the runs differ")
        tie = check_near_tie(gen, prompt, greedy, toks, tag, f"oracle {kind} vs greedy")
        full = stats["n_cycles"] if tie is None else tie["step"] // (depth + 1)
        if stats["n_accepted"] < depth * full:
            raise AssertionError(f"{tag} oracle {kind}: {stats}, expected {depth} accepted "
                                 f"per cycle")
        out[kind] = dict(stats=stats, tokens_per_s=spread(tps), vs_greedy=tie)
        log(f"[{tag}] oracle {kind} graphed C=1 (upper bound, not a result): tokens/s min / "
            f"median / max {fmt(out[kind]['tokens_per_s'])}, mean_accept_len "
            f"{stats['mean_accept_len']:.3f} ({stats['n_accepted']} accepted in "
            f"{stats['n_cycles']} cycles; depth {depth})")
        del eng
        torch.cuda.empty_cache()
    return out


def main_path(report: dict) -> dict:
    import numpy as np
    import torch

    from eagle_tpu_torch.models.synth import VICUNA_7B, synth_eagle_params, synth_llama_params

    os.environ.pop("EAGLE_TPU_FUSED_FFN", None)  # the coded Q4_K path: unfused
    cfg = VICUNA_7B
    t0 = time.time()
    params = synth_llama_params(cfg, seed=0, packed=True, coded=True, device="cuda")
    draft = synth_eagle_params(cfg, seed=1, packed=True, device="cuda")
    torch.cuda.synchronize()
    log(f"[synth] Vicuna-7B Q4_K packed coded target + draft on the card in "
        f"{time.time() - t0:.1f} s, {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, size=300)
    n_new = 65  # the prefill's token + 64 decoded

    torch.cuda.reset_peak_memory_stats()
    cell = serve_cell("q4_k", params, draft, cfg, None, prompt, n_new,
                      {"qmm_gemv": DECODE_QMM, "qmm": 0}, VERIFY_QMM, fused=False)
    peak = torch.cuda.max_memory_allocated()
    log(f"[q4_k] peak device memory over the cell (eager and graphed greedy and EAGLE "
        f"engines, max_seq 1024): {peak / 2**30:.2f} GiB")
    gen = cell.pop("gen")
    res = cell["variants"]
    at_first = res["greedy graphed"]["launches_at_first_token"]
    counts_greedy = res["greedy graphed"]["launches"]
    launches = res["eagle graphed C=1"]["launches"]  # greedy + EAGLE, the default path
    log(f"[launches] phases 3-4 (graphed greedy + EAGLE C=1, replays counted): {launches}")
    log(f"[launches] greedy prompt (300 tokens, bucket 512): qmm_tc {at_first['qmm_tc']}, "
        f"qmm {at_first['qmm']}; EAGLE prompt and decode: qmm_tc "
        f"{launches['qmm_tc'] - counts_greedy['qmm_tc']}; greedy qmm_mma "
        f"{counts_greedy['qmm_mma']}")
    if at_first["qmm_tc"] != PROMPT_QMM:
        raise AssertionError(f"greedy prompt: {at_first['qmm_tc']} tensor-core qmm launches, "
                             f"expected {PROMPT_QMM}")
    if launches["qmm_tc"] - counts_greedy["qmm_tc"] <= PROMPT_QMM:
        raise AssertionError("EAGLE prompt: the draft's prompt products missed the tensor-core body")
    if counts_greedy["qmm_mma"]:
        raise AssertionError(f"greedy decode ran {counts_greedy['qmm_mma']} qmm_mma launches")
    eagle_gemv = launches["qmm_gemv"] - counts_greedy["qmm_gemv"]
    n_cyc = res["eagle graphed C=1"]["cycles_run"]
    log(f"[launches] EAGLE (the draft's 1-row products): qmm_gemv {eagle_gemv} over {n_cyc} "
        f"cycles ({eagle_gemv / n_cyc:.1f} per cycle), SIMT qmm "
        f"{launches['qmm'] - counts_greedy['qmm']}")

    # the prompt's logits: finite, of the expected shape, and the first token
    t = 512
    padded = np.zeros((1, t), np.int32)
    padded[0, : len(prompt)] = prompt
    logits, _, _ = gen._prefill(torch.from_numpy(padded).cuda(),
                                torch.tensor([len(prompt)], dtype=torch.int32, device="cuda"), t)
    if tuple(logits.shape) != (1, cfg.vocab_size) or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"prefill logits: shape {tuple(logits.shape)} or non-finite")
    if int(logits.argmax()) != cell["greedy_tokens"][0]:
        raise AssertionError("prefill is not deterministic: first token differs")

    report["main_path"] = dict(
        cell, peak_gib=peak / 2**30, launches=launches,
        launches_per_decoded_token=res["greedy graphed"]["launches_per_decoded_token"],
        launches_at_first_token=at_first)
    return launches, dict(params=params, draft=draft, cfg=cfg, prompt=prompt, n_new=n_new,
                          greedy=cell["greedy_tokens"], gen=gen)


def tree_phase(report: dict, q4k: dict) -> dict:
    """The tree engines on the Q4_K cell after the same prompt: the static
    tree eager and graphed, EAGLE-2 eager, graphed at C = 1 and at C = 4;
    then the oracle runs. Returns the launch counts of each engine's
    graphed C = 1 run (the tree path's default), read from zero."""
    m = q4k
    cell = tree_cell("q4_k tree", m["params"], m["draft"], m["cfg"], None, m["prompt"],
                     m["n_new"], m["greedy"], m["gen"],
                     (("tree", False, 1), ("tree", True, 1), ("tree2", False, 1),
                      ("tree2", True, 1), ("tree2", True, 4)), fused=False, draft_fused=False)
    longer = m["gen"].generate(m["prompt"], max_new_tokens=m["n_new"] + 8, stop_at_eos=False)
    cell["oracle"] = oracle_runs("q4_k tree", m["params"], m["draft"], m["cfg"], None,
                                 m["prompt"], m["n_new"], m["greedy"], m["gen"], longer)
    report["tree_path"] = cell
    return {k: cell["variants"][f"{k} graphed C=1"]["launches"] for k in ("tree", "tree2")}


# --------------------------------------------------------------------------
# phase 6: the GGUF path


GGUF_FREE_BYTES = 5 * 2**30  # the two files take 4.2 GB
#: the rotary LayerNorm families' minted tensors beside the llama layer's
#: (llama.cpp's tensor tables): no ffn_gate, and a bias on every norm, q/k/v,
#: attn_output, ffn_up and ffn_down; phi2 has one shared input norm (no
#: ffn_norm) and an output.bias
LN_MINT = {"starcoder2": dict(ffn_norm=True, out_b=False),
           "phi2": dict(ffn_norm=False, out_b=True)}
#: the position families' minted tensors (llama.cpp's tensor tables): a fused
#: attn_qkv, no ffn_gate, LayerNorm; with `biases` a bias on every norm,
#: attn_qkv, attn_output, ffn_up and ffn_down (StarCoder, BLOOM; MPT has none);
#: StarCoder's learned positions `position_embd` [ctx, d] F32, BLOOM's
#: embedding LayerNorm `token_embd_norm` (weight and bias)
POS_MINT = {"starcoder": dict(biases=True, pos_embd=True, embd_norm=False),
            "bloom": dict(biases=True, pos_embd=False, embd_norm=True),
            "mpt": dict(biases=False, pos_embd=False, embd_norm=False)}
#: the other LayerNorm families' minted tensors (llama.cpp's tensor tables):
#: a fused attn_qkv, an ffn_gate, an ffn_norm, any norm tensor at all
#: (`norms`: OLMo has none), biases on the norms, on the matmuls of
#: `mat_b`, and output.bias
LNF_MINT = {
    "nemotron": dict(fused=False, gate=False, ffn_norm=True, norms=True, norm_b=True, mat_b=(),
                     out_b=False),
    "olmo": dict(fused=False, gate=True, ffn_norm=True, norms=False, norm_b=False, mat_b=(),
                 out_b=False),
    "orion": dict(fused=False, gate=True, ffn_norm=True, norms=True, norm_b=True, mat_b=(),
                  out_b=False),
    "codeshell": dict(fused=True, gate=False, ffn_norm=True, norms=True, norm_b=True,
                      mat_b=("attn_qkv", "attn_output", "ffn_up", "ffn_down"), out_b=False),
    "falcon": dict(fused=True, gate=False, ffn_norm=False, norms=True, norm_b=True, mat_b=(),
                   out_b=False),
    "gptj": dict(fused=False, gate=False, ffn_norm=False, norms=True, norm_b=True,
                 mat_b=("ffn_up", "ffn_down"), out_b=True),
}
#: random blocks' f16 magnitude of each minted format: Q4_0 (w = d (q - 8)),
#: Q4_K (w = d sc q - dmin m), Q5_0 (w = d (q - 16)) and Q8_0 (w = d q) at a
#: weight RMS of ~6e-3; the heads' (unsigned d: peaked logits) Q6_K and Q8_0
#: at an RMS of ~0.14
LAYER_MAGS = {"Q4_0": 1.3e-3, "Q4_K": 1.85e-5, "Q5_0": 6.7e-4, "Q8_0": 8e-5}
HEAD_MAGS = {"Q6_K": 1e-4, "Q8_0": 1.85e-3}


def random_blocks(gen, n: int, k: int, qtype: int, d_mag: float, signed: bool) -> "np.ndarray":
    """GGUF blocks of random bytes for an [n, k] tensor of `qtype`, made on
    the card. Each f16 field of a block (`F16_FIELDS`) is set to a finite
    value in [0.5, 1.5) x d_mag (of random sign when `signed`), so that
    activations stay finite over 32 layers. IQ1_M has no f16 field: its
    scale is the top nibbles of its four scale words, set here the same way."""
    import torch

    from eagle_tpu_torch.gguf.constants import F16_FIELDS, GGML_TYPE_TRAITS, GGMLType

    tr = GGML_TYPE_TRAITS[GGMLType(qtype)]
    nb = n * k // tr.block_size
    raw = torch.randint(0, 256, (nb, tr.type_size), generator=gen, device="cuda",
                        dtype=torch.uint8)

    def scale_bytes():
        d = (torch.rand(nb, generator=gen, device="cuda") + 0.5) * d_mag
        if signed:
            d = d * (torch.randint(0, 2, (nb,), generator=gen, device="cuda") * 2 - 1)
        return d.half().view(torch.uint8).view(nb, 2)

    for at in F16_FIELDS[GGMLType(qtype)]:
        raw[:, at:at + 2] = scale_bytes()
    if GGMLType(qtype) == GGMLType.IQ1_M:
        bits = scale_bytes().to(torch.int32)
        bits = bits[:, 0] | (bits[:, 1] << 8)
        for word in range(4):  # nibble `word` of d is the top nibble of word `word`
            hi = 48 + 2 * word + 1
            raw[:, hi] = (raw[:, hi] & 0x0F) | (((bits >> (4 * word)) & 0xF) << 4).to(torch.uint8)
    return raw.cpu().numpy().reshape(-1)


def mint_gguf_pair(tmp: pathlib.Path, seed: int, d: int = 4096, f: int = 11008, v: int = 32000,
                   n_layers: int = 32, n_heads: int = 32, tag: str = "vicuna-7b",
                   ctx: int = 2048, rope_base: float = 10000.0, metadata: dict | None = None,
                   vocab: dict | None = None, with_draft: bool = True,
                   n_kv_heads: int | None = None, layer_type: str = "Q4_0",
                   rope_factors=None, tied: bool = False, arch: str = "llama",
                   head_dim: int | None = None, rope_dim: int | None = None,
                   types: dict | None = None, moe: dict | None = None
                   ) -> tuple[pathlib.Path, pathlib.Path | None]:
    """Write a Vicuna-7B-shape GGUF (or one of the widths given) laid out as
    llama-quantize's Q4_0 lays out a llama-7B file (every layer matmul and
    token_embd Q4_0, output Q6_K, norms F32, llama metadata and an SPM
    vocabulary of `v` pieces, `spm_vocab`, or `vocab`'s keys), and an EAGLE
    draft GGUF in Q8_0 (one layer, fc, token_embd; fc.bias F32), unless
    `with_draft` is False. `ctx` is the context length, `rope_base` the
    rope frequency base of both files; `metadata` adds target keys (rope
    scaling). `n_kv_heads` (both files; default `n_heads`) sets GQA,
    `layer_type` "Q4_K" lays the target out as Q4_K_M does (layers and
    token_embd Q4_K), `rope_factors` adds `rope_freqs.weight` (Llama-3.1),
    and `tied` leaves out `output.weight` and makes token_embd Q6_K, the
    head (Llama-3.2-1B / 3B). `arch` "qwen2", "qwen3", "gemma" or "gemma2"
    writes the target under that architecture with its tensors (qwen2:
    q/k/v biases; qwen3: per-head q/k norms; gemma2: the post-attention and
    post-FFN norms; gemma: none; an arch of `LN_MINT`, starcoder2 or phi2,
    or of `POS_MINT`, starcoder, bloom or mpt: the tensors its layout names,
    and `layer_norm_epsilon` 1e-5), `head_dim`
    a head width other than d / n_heads (both files), `rope_dim` the
    target's rotary features (partial rotary); an arch of `LNF_MINT`
    (nemotron, olmo, orion, codeshell, falcon, gptj) the tensors its layout
    names. `types` sets the format of a target tensor by its GGUF name
    ("attn_qkv", ..., "token_embd", "output"), as llama-quantize's Q4_K_M
    falls back to Q5_0 and Q8_0 where K % 256 != 0 (Falcon-7B). `moe`
    (n_expert, n_used, f_exp, shexp: the shared expert's width or 0) gives
    the target's layers experts in place of the dense FFN, as llama.cpp
    writes them: an F32 router `ffn_gate_inp` [E, d], the stacks
    `ffn_{gate,up}_exps` [E, f_exp, d] and `ffn_down_exps` [E, d, f_exp]
    (formats by `types`, as the other tensors), and with `shexp` the shared
    expert `ffn_{gate,up,down}_shexp` with its F32 gate
    `ffn_gate_inp_shexp` [1, d]; `{arch}.expert_count` and
    `{arch}.expert_used_count` (and for qwen2moe the experts' widths) in
    the metadata; the draft keeps its dense FFN of `f`.
    Weights are random quant blocks, at magnitudes that give Q4_0's weight
    RMS (~6e-3) in every layer format (`LAYER_MAGS`)."""
    import torch

    from eagle_tpu_torch.gguf import GGMLType, GGUFWriter

    gen = torch.Generator(device="cuda").manual_seed(seed)
    q8_0, q6_k = GGMLType.Q8_0, GGMLType.Q6_K
    # Q4_0: w = d (q - 8), RMS ~4.8 d; Q4_K: w = d sc q - dmin m, RMS ~336 d
    types = types or {}

    def fmt(name: str, default: str = layer_type) -> tuple:
        t = types.get(name, default)
        return GGMLType[t], (HEAD_MAGS if name == "output" else LAYER_MAGS)[t]

    kv = n_kv_heads or n_heads
    hd = head_dim or d // n_heads
    d_q, d_kv = n_heads * hd, kv * hd
    layer_mats = (("attn_q", d_q, d), ("attn_k", d_kv, d), ("attn_v", d_kv, d),
                  ("attn_output", d, d_q), ("ffn_gate", f, d), ("ffn_up", f, d),
                  ("ffn_down", d, f))

    ln, pos, lnf = LN_MINT.get(arch), POS_MINT.get(arch), LNF_MINT.get(arch)
    mats = layer_mats if ln is None else tuple(m for m in layer_mats if m[0] != "ffn_gate")
    if moe is not None:  # the experts replace the dense FFN
        mats = tuple(m for m in mats if not m[0].startswith("ffn_"))
    if pos is not None or (lnf is not None and lnf["fused"]):  # a fused attn_qkv
        mats = (("attn_qkv", d_q + 2 * d_kv, d),) + mats[3:]
    if pos is not None or (lnf is not None and not lnf["gate"]):  # no gate
        mats = tuple(m for m in mats if m[0] != "ffn_gate")
    norms = lnf is None or lnf["norms"]

    def writer(path, arch, blocks, file_type):
        w = GGUFWriter(path)
        for key, val in {
            "general.architecture": arch, "general.name": f"{arch} {tag}-shape random",
            "general.file_type": file_type, f"{arch}.context_length": ctx,
            f"{arch}.embedding_length": d, f"{arch}.block_count": blocks,
            f"{arch}.feed_forward_length": f, f"{arch}.attention.head_count": n_heads,
            f"{arch}.attention.head_count_kv": kv,
            f"{arch}.attention.layer_norm_rms_epsilon": 1e-6,
            f"{arch}.rope.dimension_count": rope_dim if arch != "eagle" and rope_dim else hd,
            f"{arch}.rope.freq_base": rope_base,
            f"{arch}.attention.key_length": hd, f"{arch}.attention.value_length": hd,
            f"{arch}.vocab_size": v,
        }.items():
            w.add(key, val)
        return w

    def add(w, name, n, k, qtype, mag, signed=True):
        w.add_tensor(name, random_blocks(gen, n, k, qtype, mag, signed), qtype, raw_shape=(n, k))

    def norm(n=d):
        return (torch.rand(n, generator=gen, device="cuda") * 0.4 + 0.8).cpu().numpy()

    def bias(n):
        return (torch.randn(n, generator=gen, device="cuda") * 0.1).cpu().numpy()

    target = tmp / f"{tag}-{layer_type.lower()}.gguf"
    # LLAMA_FTYPE_MOSTLY_Q4_0, LLAMA_FTYPE_MOSTLY_Q4_K_M
    w = writer(target, arch, n_layers, 2 if layer_type == "Q4_0" else 15)
    if ln is not None or pos is not None or lnf is not None:
        w.add(f"{arch}.attention.layer_norm_epsilon", 1e-5)
    if moe is not None:
        w.add(f"{arch}.expert_count", moe["n_expert"])
        w.add(f"{arch}.expert_used_count", moe["n_used"])
        if arch == "qwen2moe":
            w.add(f"{arch}.expert_feed_forward_length", moe["f_exp"])
            w.add(f"{arch}.expert_shared_feed_forward_length", moe["shexp"])
    for key, val in {**(vocab or spm_vocab(v, seed)), **(metadata or {})}.items():
        w.add(key, val)
    if tied:
        add(w, "token_embd.weight", v, d, q6_k, 1e-4, signed=False)
    else:
        add(w, "token_embd.weight", v, d, *fmt("token_embd"))
    if pos is not None and pos["pos_embd"]:
        w.add_tensor("position_embd.weight",
                     (torch.randn((ctx, d), generator=gen, device="cuda") * 1e-2).cpu().numpy())
    if pos is not None and pos["embd_norm"]:
        w.add_tensor("token_embd_norm.weight", norm())
        w.add_tensor("token_embd_norm.bias", bias(d))
    for i in range(n_layers):
        if norms:
            w.add_tensor(f"blk.{i}.attn_norm.weight", norm())
        for name, n, k in mats:
            add(w, f"blk.{i}.{name}.weight", n, k, *fmt(name))
        if moe is not None:
            n_exp, f_exp, fs = moe["n_expert"], moe["f_exp"], moe["shexp"]
            # the router at a logit spread of ~1.3 over normed inputs
            w.add_tensor(f"blk.{i}.ffn_gate_inp.weight", (torch.randn(
                (n_exp, d), generator=gen, device="cuda") * 0.02).cpu().numpy())
            for name, n, k in (("ffn_gate_exps", f_exp, d), ("ffn_up_exps", f_exp, d),
                               ("ffn_down_exps", d, f_exp)):
                qt, mag = fmt(name)
                w.add_tensor(f"blk.{i}.{name}.weight",
                             random_blocks(gen, n_exp * n, k, qt, mag, True), qt,
                             raw_shape=(n_exp, n, k))
            if fs:
                for name, n, k in (("ffn_gate_shexp", fs, d), ("ffn_up_shexp", fs, d),
                                   ("ffn_down_shexp", d, fs)):
                    add(w, f"blk.{i}.{name}.weight", n, k, *fmt(name))
                w.add_tensor(f"blk.{i}.ffn_gate_inp_shexp.weight", (torch.randn(
                    (1, d), generator=gen, device="cuda") * 0.02).cpu().numpy())
        if (ln is None or ln["ffn_norm"]) and (lnf is None or lnf["ffn_norm"] and norms):
            w.add_tensor(f"blk.{i}.ffn_norm.weight", norm())
        if pos is not None and pos["biases"]:
            w.add_tensor(f"blk.{i}.attn_norm.bias", bias(d))
            w.add_tensor(f"blk.{i}.ffn_norm.bias", bias(d))
            for name, n in (("attn_qkv", d_q + 2 * d_kv), ("attn_output", d), ("ffn_up", f),
                            ("ffn_down", d)):
                w.add_tensor(f"blk.{i}.{name}.bias", bias(n))
        elif ln is not None:
            w.add_tensor(f"blk.{i}.attn_norm.bias", bias(d))
            if ln["ffn_norm"]:
                w.add_tensor(f"blk.{i}.ffn_norm.bias", bias(d))
            for name, n in (("attn_q", d_q), ("attn_k", d_kv), ("attn_v", d_kv),
                            ("attn_output", d), ("ffn_up", f), ("ffn_down", d)):
                w.add_tensor(f"blk.{i}.{name}.bias", bias(n))
        elif lnf is not None:
            if lnf["norm_b"]:
                w.add_tensor(f"blk.{i}.attn_norm.bias", bias(d))
                if lnf["ffn_norm"]:
                    w.add_tensor(f"blk.{i}.ffn_norm.bias", bias(d))
            for name, n, _ in mats:
                if name in lnf["mat_b"]:
                    w.add_tensor(f"blk.{i}.{name}.bias", bias(n))
        elif arch in ("qwen2", "qwen2moe"):
            for name, n in (("attn_q", d_q), ("attn_k", d_kv), ("attn_v", d_kv)):
                w.add_tensor(f"blk.{i}.{name}.bias", bias(n))
        elif arch == "qwen3":
            w.add_tensor(f"blk.{i}.attn_q_norm.weight", norm(hd))
            w.add_tensor(f"blk.{i}.attn_k_norm.weight", norm(hd))
        elif arch == "gemma2":
            w.add_tensor(f"blk.{i}.attn_post_norm.weight", norm())
            w.add_tensor(f"blk.{i}.ffn_post_norm.weight", norm())
    if norms:
        w.add_tensor("output_norm.weight", norm())
    if ln is not None or (pos is not None and pos["biases"]) or (lnf and lnf["norm_b"]):
        w.add_tensor("output_norm.bias", bias(d))
    if rope_factors is not None:
        w.add_tensor("rope_freqs.weight", rope_factors.astype("float32"))
    if not tied:
        add(w, "output.weight", v, d, *fmt("output", "Q6_K"), signed=False)
    if (ln is not None and ln["out_b"]) or (lnf is not None and lnf["out_b"]):
        w.add_tensor("output.bias", bias(v))
    w.write()
    del w
    if not with_draft:
        return target, None

    draft = tmp / f"eagle-{tag}-q8_0.gguf"
    w = writer(draft, "eagle", 1, 7)  # LLAMA_FTYPE_MOSTLY_Q8_0
    add(w, "token_embd.weight", v, d, q8_0, 8e-5)
    add(w, "fc.weight", d, 2 * d, q8_0, 8e-5)
    w.add_tensor("fc.bias", (torch.randn(d, generator=gen, device="cuda") * 1e-3).cpu().numpy())
    for name, n, k in layer_mats:
        add(w, f"blk.0.{name}.weight", n, k, q8_0, 8e-5)
    w.add_tensor("blk.0.ffn_norm.weight", norm())
    w.write()
    return target, draft


def same_bits(a, b) -> bool:
    import torch

    if a is None or b is None:
        return a is None and b is None
    a, b = a.detach().cpu().contiguous(), b.detach().cpu().contiguous()
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        ints = {4: torch.int32, 2: torch.int16}[a.element_size()]
        a, b = a.view(ints), b.view(ints)
    return torch.equal(a, b)


def check_repack(target: pathlib.Path, params: dict) -> list[str]:
    """Sampled tensors repacked and packed on the card equal the port's
    repack of the same file bytes on the CPU, bit for bit."""
    from eagle_tpu_torch.gguf import GGUFReader
    from eagle_tpu_torch.models.loader import load_tensor
    from eagle_tpu_torch.quant.qtensor import concat_qtensors
    from eagle_tpu_torch.quant.serving import prepare_qtensor

    reader = GGUFReader(target)

    def cpu(name, layout="kn"):
        return load_tensor(reader, name, layout=layout, device="cpu")

    lyr = params["layers"]
    checks = {
        "wo layer 0": (lyr["wo"].layer(0), cpu("blk.0.attn_output.weight")),
        "wo layer 31": (lyr["wo"].layer(31), cpu("blk.31.attn_output.weight")),
        "w_gate_up layer 7": (lyr["w_gate_up"].layer(7), concat_qtensors(
            [cpu("blk.7.ffn_gate.weight"), cpu("blk.7.ffn_up.weight")])),
        "output": (params["output"], cpu("output.weight")),
        "token_embd": (params["tok_embd"], cpu("token_embd.weight", "nk")),
    }
    for what, (card, host) in checks.items():
        host = prepare_qtensor(host, "f32")
        ok = (card.group, card.layout, card.packed, card.ggml_type) == (
            host.group, host.layout, host.packed, host.ggml_type) and all(
            same_bits(card.tensors()[k], host.tensors()[k]) for k in card.tensors())
        if not ok:
            raise AssertionError(f"repack on the card differs from the CPU's: {what}")
    reader.close()
    return list(checks)


def gguf_path(report: dict, tmp: pathlib.Path) -> tuple[dict, pathlib.Path, pathlib.Path]:
    """Mint (into `tmp`), load and serve the Q4_0 target and the Q8_0 draft
    at full Vicuna-7B width and depth: `serve_cell` (greedy and the EAGLE
    chain engine, eager and graphed) with the fused FFN block
    (EAGLE_TPU_FUSED_FFN=1), then again unfused, and whether the fused
    block pays under graphs. Returns the fused default path's launch counts
    and the two files' paths (kept for phase cli)."""
    import shutil

    import numpy as np
    import torch

    from eagle_tpu_torch.models.loader import load_eagle_params, load_llama_params
    from eagle_tpu_torch.ops.ffn import supports_ffn_block
    from eagle_tpu_torch.quant.serving import prepare_params_for_serving
    from eagle_tpu_torch.runtime.generate import Generator

    torch.cuda.empty_cache()
    out: dict = {}
    free = shutil.disk_usage(tmp).free
    log(f"[gguf] {free / 2**30:.1f} GiB free in the temporary directory")
    if free < GGUF_FREE_BYTES:
        raise RuntimeError(f"the GGUF phase needs {GGUF_FREE_BYTES / 2**30:.0f} GiB of disk")
    t0 = time.time()
    target, draft_path = mint_gguf_pair(tmp, seed=21)
    out["mint_s"] = time.time() - t0
    out["file_bytes"] = {"target": target.stat().st_size, "draft": draft_path.stat().st_size}
    log(f"[gguf] minted {target.name} ({out['file_bytes']['target'] / 1e9:.3f} GB) and "
        f"{draft_path.name} ({out['file_bytes']['draft'] / 1e9:.3f} GB) in {out['mint_s']:.1f} s")

    torch.cuda.reset_peak_memory_stats()
    times_t, times_d = {}, {}
    t0 = time.time()
    params, cfg, _ = load_llama_params(target, device="cuda", times=times_t)
    draft, dcfg, _ = load_eagle_params(draft_path, device="cuda", times=times_d)
    t_load = time.time() - t0
    t0 = time.time()
    params = prepare_params_for_serving(params, "f32")
    draft = prepare_params_for_serving(draft, "f32")
    torch.cuda.synchronize()
    t_prep = time.time() - t0
    out.update(load_s=t_load, prepare_s=t_prep, load_times_target=times_t,
               load_times_draft=times_d, device_gib=torch.cuda.memory_allocated() / 2**30,
               load_peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    log(f"[gguf] loaded on the card in {t_load:.2f} s (target "
        + ", ".join(f"{k} {v:.2f} s" for k, v in times_t.items()) + "; draft "
        + ", ".join(f"{k} {v:.2f} s" for k, v in times_d.items())
        + f"), serving prep {t_prep:.2f} s; {out['device_gib']:.2f} GiB on the card, peak "
        f"{out['load_peak_gib']:.2f} GiB")
    out["repack_checked"] = check_repack(target, params)
    log(f"[gguf] repacked on the card == repacked on the CPU, bit for bit: "
        f"{', '.join(out['repack_checked'])}")

    prompt = np.random.default_rng(1).integers(0, cfg.vocab_size, size=300)
    n_new = 65
    runs = {}
    for mode in ("1", "0"):
        if mode == "1":
            os.environ["EAGLE_TPU_FUSED_FFN"] = "1"
        else:
            os.environ.pop("EAGLE_TPU_FUSED_FFN", None)
        tag = "gguf fused" if mode == "1" else "gguf unfused"
        want_tok = {"qmm_gemv": DECODE_QMM_FUSED if mode == "1" else DECODE_QMM,
                    "ffn_out_norm": 32 if mode == "1" else 0,
                    "gate_up_act": 32 if mode == "1" else 0, "qmm": 0}
        cell = serve_cell(tag, params, draft, cfg, dcfg, prompt, n_new, want_tok,
                          VERIFY_QMM_FUSED if mode == "1" else VERIFY_QMM, fused=mode == "1")
        fused = mode == "1"
        cell["tree2"] = tree_cell(f"{tag} tree2", params, draft, cfg, dcfg, prompt, n_new,
                                  cell["greedy_tokens"], cell.pop("gen"), (("tree2", True, 1),),
                                  fused=fused,
                                  draft_fused=fused and supports_ffn_block(draft["layers"], dcfg))
        runs[tag.split()[1]] = cell
    fused_launches = runs["fused"]["variants"]["eagle graphed C=1"]["launches"]
    dev = {k: runs[k]["graphed_device"]["step_ms"] for k in ("fused", "unfused")}
    tps = {k: runs[k]["variants"]["greedy graphed"]["tokens_per_s"]["median"]
           for k in ("fused", "unfused")}
    out["fused_pays_under_graphs"] = dict(device_ms_per_token=dev, median_tokens_per_s=tps,
                                          pays=dev["fused"] < dev["unfused"]
                                          and tps["fused"] > tps["unfused"])
    log(f"[gguf] fused FFN block under graphs: device {dev['fused']:.3f} ms/token fused vs "
        f"{dev['unfused']:.3f} unfused, greedy median {tps['fused']:.2f} vs "
        f"{tps['unfused']:.2f} tokens/s: "
        + ("pays" if out["fused_pays_under_graphs"]["pays"] else "does not pay on both"))
    # the unfused generator is the reference for the fused one's tokens
    gen = Generator(params, cfg, max_seq=1024, batch=1, kv_dtype=torch.bfloat16,
                    compute_dtype=torch.bfloat16, eos_id=-1)
    out["fused_vs_unfused"] = check_near_tie(gen, prompt, runs["unfused"]["greedy_tokens"],
                                             runs["fused"]["greedy_tokens"], "gguf",
                                             "fused vs unfused greedy")
    out["tree2_fused_vs_unfused"] = check_near_tie(
        gen, prompt, runs["unfused"]["tree2"]["tokens"]["tree2"],
        runs["fused"]["tree2"]["tokens"]["tree2"], "gguf", "EAGLE-2 fused vs unfused")
    out["runs"] = runs
    report["gguf_path"] = out
    del gen, params, draft
    torch.cuda.empty_cache()
    return fused_launches, target, draft_path

# --------------------------------------------------------------------------
# phase cli: the normal entry point on phase 6's files


CLI_NEW = 64  # the CLI runs' -n
FLAT_NEW = 24  # new tokens of the flat-chain checks
CLI_CONFIGS = (("plain", 1), ("chain", 1), ("chain", 4), ("tree", 1), ("tree2", 1))


def spm_vocab(v: int, seed: int) -> dict:
    """Vicuna's tokenizer layout as GGUF metadata, built as the reference's
    tests build one (tests/test_tokenizer.py): <unk>, <s>, </s>, the 256
    byte tokens <0x00>-<0xFF>, then '▁' and the letters with and without
    it, then seeded words and fragments (70 % '▁'-prefixed) with all their
    prefixes, so merges reach whole words; scores descend; BOS 1, EOS 2."""
    import numpy as np

    rng = np.random.default_rng(seed)
    letters = list("abcdefghijklmnopqrstuvwxyz")
    tokens = ["<unk>", "<s>", "</s>"] + [f"<0x{b:02X}>" for b in range(256)]
    ttypes = [2, 3, 3] + [6] * 256
    pieces = ["▁"] + letters + ["▁" + c for c in letters]
    seen = set(pieces)
    while len(tokens) + len(pieces) < v:
        w = "".join(rng.choice(letters, size=int(rng.integers(2, 9))))
        w = "▁" + w if rng.random() < 0.7 else w
        for i in range(2, len(w) + 1):
            if w[:i] not in seen:
                seen.add(w[:i])
                pieces.append(w[:i])
    pieces = pieces[: v - len(tokens)]
    return {"tokenizer.ggml.model": "llama", "tokenizer.ggml.tokens": tokens + pieces,
            "tokenizer.ggml.scores": np.asarray([0.0] * len(tokens) + [-float(i) for i in
                                                                      range(len(pieces))],
                                                np.float32),
            "tokenizer.ggml.token_type": np.asarray(ttypes + [1] * len(pieces), np.int32),
            "tokenizer.ggml.bos_token_id": 1, "tokenizer.ggml.eos_token_id": 2,
            "tokenizer.ggml.add_bos_token": True}


def cli_prompt(tokens: list, n_words: int = 300, seed: int = 5) -> str:
    """About `n_words` tokens of text: seeded whole '▁' words of the vocab."""
    import numpy as np

    words = [t[1:] for t in tokens if t.startswith("▁") and len(t) >= 4 and t[1:].isalpha()]
    rng = np.random.default_rng(seed)
    return " ".join(words[i] for i in rng.integers(0, len(words), n_words))


def run_clis(target, draft, prompt: str) -> dict:
    """The three CLI runs as subprocesses, at most two at a time (a load
    peaks at ~22 GiB on the card): the defaults twice (seed 0) and --temp 0.
    Each must exit 0 and print its text and its `[speculative]` line; the
    two default runs must print the same text."""
    env = {k: v for k, v in os.environ.items() if k != "EAGLE_TPU_FUSED_FFN"}
    base = [sys.executable, "-m", "eagle_tpu_torch.tools.cli", "-m", str(target), "--draft",
            str(draft), "-p", prompt, "-n", str(CLI_NEW)]
    runs = {"default": base, "default again": base, "temp 0": base + ["--temp", "0"]}
    t0 = time.time()
    out = {}
    done = {}
    for group in (("default", "temp 0"), ("default again",)):
        procs = {k: subprocess.Popen(runs[k], cwd=pathlib.Path(__file__).resolve().parent,
                                     env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                     text=True) for k in group}
        done.update({k: (p, *p.communicate(timeout=600)) for k, p in procs.items()})
    for name in runs:
        p, stdout, stderr = done[name]
        lines = [ln for ln in stderr.splitlines() if ln.startswith("[")]
        spec = [ln for ln in lines if ln.startswith("[speculative] accept_rate=")]
        if p.returncode != 0 or not stdout.strip() or not spec:
            raise AssertionError(f"cli {name}: exit {p.returncode}, stdout {stdout[-400:]!r}, "
                                 f"stderr {stderr[-2000:]}")
        out[name] = dict(text=stdout.rstrip("\n"), lines=lines)
        log(f"[cli] {name}: exit 0, {' '.join(lines)}; text {stdout.strip()[:80]!r}...")
    if out["default"]["text"] != out["default again"]["text"]:
        raise AssertionError("cli: two seed-0 runs at the defaults printed different text")
    log(f"[cli] the two seed-0 runs printed the same text ({len(out['default']['text'])} "
        f"characters); three runs in {time.time() - t0:.1f} s")
    return out


def sampler_share(report: dict, res: dict) -> dict:
    """The sampler's device ms per token and per cycle on the path itself:
    each sampled cell's graphed device ms (CUDA events over replays) less
    the greedy cell's that phase 6 measured on the same files, unfused:
    the greedy step, the chain cycle at C = 1 and 4, EAGLE-2 at C = 1 (no
    greedy static-tree cell runs on these files). Phase 6's chain takes
    post-norm features and this phase's Engine pre-norm ones, which moves
    nothing on the verify's side."""
    unfused = report["gguf_path"]["runs"]["unfused"]
    dev = unfused["graphed_device"]
    greedy = {"plain": dev["step_ms"], "chain C=1": dev["cycle_c1_ms"],
              "chain C=4": dev["cycle_c4_ms"],
              "tree2 C=1": unfused["tree2"]["variants"]["tree2 graphed C=1"]["device"]["ms"]}
    out = {name: dict(sampled_ms=res[name]["device"]["ms"], greedy_ms=ms,
                      share_ms=res[name]["device"]["ms"] - ms) for name, ms in greedy.items()}
    log("[cli] the sampler's share of the device time (sampled cell less phase 6's greedy "
        "cell, ms per token or cycle): " + "; ".join(
            f"{k} {v['sampled_ms']:.3f} - {v['greedy_ms']:.3f} = {v['share_ms']:.3f}"
            for k, v in out.items()))
    return out


def flat_sampler_checks(eng, ids, generate) -> dict:
    """Where the defaults leave one token per step (top-p 0.95 and min-p
    0.05 over a random model's peaked logits), a draw decides nothing. So
    every engine runs again under a flat chain (top-k 40, temperature a
    quarter of the prompt's top-1 to top-40 logit gap, top-p and min-p
    off): eager once and graphed twice from seed 0, the same tokens bit for
    bit, no eager body after the capture, seed 1 another stream."""
    import numpy as np
    import torch

    from eagle_tpu_torch.runtime.sampling import SamplerConfig

    gen = eng._plain_generator()
    t = 512
    padded = np.zeros((1, t), np.int32)
    padded[0, : len(ids)] = ids
    logits, _, _ = gen._prefill(torch.from_numpy(padded).cuda(),
                                torch.tensor([len(ids)], dtype=torch.int32, device="cuda"), t)
    top = torch.topk(logits[0].float(), 40).values
    flat = SamplerConfig(temperature=float(top[0] - top[-1]) / 4, top_k=40, top_p=1.0,
                         min_p=0.0)
    out = {"sampler": dataclasses.asdict(flat)}
    for kind in ("plain", "chain", "tree", "tree2"):
        e = gen if kind == "plain" else eng.make_engine(kind, sampler=flat)
        e.graphs.enabled = False
        want, stats = generate(e, 1, scfg=flat, n=FLAT_NEW)
        e.graphs.enabled = True
        generate(e, 1, scfg=flat, n=FLAT_NEW)  # the capture
        warm = e.graphs.eager
        again = generate(e, 1, scfg=flat, n=FLAT_NEW)[0]
        other = generate(e, 1, seed=1, scfg=flat, n=FLAT_NEW)[0]
        if again != want or e.graphs.eager != warm or other == want:
            raise AssertionError(f"cli flat {kind}: graphed != eager, an eager body after the "
                                 f"capture, or seed 1 gave seed 0's stream")
        out[kind] = dict(distinct_tokens=len(set(want)), stats=stats)
        log(f"[cli flat] {kind}: temp {flat.temperature:.3f}, top-k 40: graphed == eager bit for "
            f"bit, seed 1 another stream; {len(set(want))} distinct tokens of {len(want)}"
            + ("" if stats is None else f", accept_rate {stats['accept_rate']:.3f}, "
                                        f"mean_accept_len {stats['mean_accept_len']:.3f}"))
        if kind != "plain":
            del e
            torch.cuda.empty_cache()
    return out


def cli_path(report: dict, target, draft) -> None:
    """The normal entry point on phase 6's minted files: three CLI runs as
    subprocesses, then one `Engine` (the chain, the CLI's defaults, graphed)
    and from its loaded params `Generator`, the chain at C = 1 and 4, the
    static tree (4, 2, 2) and EAGLE-2 (8, 6, 32), all sampled at the CLI's
    defaults: each eager once, graphed once to capture and 2 timed graphed
    runs, all from seed 0 and all giving the same tokens bit for bit, no
    eager body after the capture, launches per token and per cycle as the
    greedy cells'. Then `flat_sampler_checks`, and at temp 0 each engine
    against the greedy Generator under the near-tie rule."""
    import torch

    from eagle_tpu_torch import _build
    from eagle_tpu_torch.api import Engine, EngineConfig
    from eagle_tpu_torch.gguf import GGUFReader
    from eagle_tpu_torch.runtime.generate import Generator
    from eagle_tpu_torch.runtime.sampling import SamplerConfig

    os.environ.pop("EAGLE_TPU_FUSED_FFN", None)
    out: dict = {}
    with GGUFReader(target) as reader:
        prompt = cli_prompt(reader.metadata["tokenizer.ggml.tokens"])
    out["runs"] = run_clis(target, draft, prompt)
    t0 = time.time()
    eng = Engine(EngineConfig(model_path=target, draft_path=draft, sampler=SamplerConfig()))
    torch.cuda.synchronize()
    out["load_s"] = time.time() - t0
    tok = eng.tokenizer
    ids = tok.encode(prompt)
    log(f"[cli] Engine (chain, the CLI's defaults: temp 0.8, top-k 40, top-p 0.95, min-p "
        f"0.05; max_seq {eng.cfg.max_seq}, {eng.cfg.feature_source} features) loaded in "
        f"{out['load_s']:.1f} s; the prompt is {len(ids)} tokens ({len(prompt)} characters)")

    sampler = SamplerConfig()
    engines = {"plain": eng._plain_generator(), "chain": eng.engine,
               "tree": eng.make_engine("tree"), "tree2": eng.make_engine("tree2")}

    def generate(e, c, cb=None, seed=0, scfg=sampler, n=CLI_NEW):
        if isinstance(e, Generator):
            return e.generate(ids, n, sampler=scfg, seed=seed, stop_at_eos=False,
                              on_token=cb), None
        return e.generate(ids, n, seed=seed, stop_at_eos=False, on_token=cb,
                          cycles_per_dispatch=c)

    res: dict = {}
    eager: dict = {}  # each engine's eager tokens (the chain's at C = 1 serve C = 4 too)
    card = CardSampler()
    with card:
        for kind, c in CLI_CONFIGS:
            name = f"{kind} C={c}" if kind != "plain" else "plain"
            e = engines[kind]
            if kind not in eager:
                e.graphs.enabled = False
                eager[kind] = generate(e, c)[0]
                e.graphs.enabled = True
            want = eager[kind]
            if generate(e, c)[0] != want:  # the capture run
                raise AssertionError(f"cli {name}: graphed tokens differ from eager tokens")
            warm = e.graphs.eager
            r = res[name] = {"tokens_per_s": [], "ttft_ms": [], "wall_ms_per_step": []}
            for _ in range(REPS):
                run0 = getattr(e, "cycles_run", 0)
                _build.reset_counts()
                (toks, stats), ttft, t_dec, at_first, _ = timed_run(
                    lambda cb: generate(e, c, cb))
                if toks != want:
                    raise AssertionError(f"cli {name}: graphed tokens differ from eager tokens")
                if any(_build.plain_calls.values()):
                    raise AssertionError(f"cli {name}: plain versions ran: {_build.plain_calls}")
                steps = (e.cycles_run - run0) if stats else len(toks) - 1
                per = {k: (_build.launches[k] - at_first[k]) / steps for k in _build.launches}
                if kind == "plain":
                    want_per = {"qmm_gemv": DECODE_QMM, "qmm": 0}
                elif kind == "chain":
                    want_per = {"qmm_mma": VERIFY_QMM}
                else:
                    want_per = tree_cycle_launches(e, False, False)
                if any(per[k] != v for k, v in want_per.items()):
                    raise AssertionError(f"cli {name}: launches per step {per}, expected "
                                         f"{want_per}")
                r["tokens_per_s"].append((len(toks) - 1) / t_dec)
                r["ttft_ms"].append(ttft * 1e3)
                r["wall_ms_per_step"].append(t_dec / steps * 1e3)
                r.update(stats=stats, launches_per_step={k: v for k, v in per.items() if v})
            if e.graphs.eager != warm:
                raise AssertionError(f"cli {name}: a body ran eagerly after the warm-up")
            if kind == "plain":
                pos = len(ids) + CLI_NEW - 1
                lim = e.kv_read_bucket(pos + 16)
                last = torch.tensor([want[-1]], dtype=torch.int32, device="cuda")
                r["device"] = timed_events(
                    lambda: e._decode_chunk(last, pos, sampler, 16, kv_limit=lim), 16)
            else:
                r["device"] = cycle_device_ms(e, ids, c)
            if e.graphs.eager != warm:
                raise AssertionError(f"cli {name}: a body ran eagerly while timed")
    for name, r in res.items():
        for key in ("tokens_per_s", "ttft_ms", "wall_ms_per_step"):
            r[key] = spread(r[key])
        r["idle_share"] = 1 - r["device"]["ms"] / r["wall_ms_per_step"]["median"]
        st = r["stats"]
        unit = "token" if st is None else "cycle"
        extra = "" if st is None else (f", accept_rate {st['accept_rate']:.3f}, "
                                       f"mean_accept_len {st['mean_accept_len']:.3f}, "
                                       f"{st['n_cycles']} cycles")
        log(f"[cli sampled] {name}: tokens/s min / median / max {fmt(r['tokens_per_s'])}, "
            f"TTFT ms {fmt(r['ttft_ms'], 1)}, wall ms per {unit} {fmt(r['wall_ms_per_step'])}, "
            f"device {r['device']['ms']:.3f} ms per {unit} (CUDA events over replays), idle "
            f"{100 * r['idle_share']:.1f}%{extra}; launches per {unit}: "
            + ", ".join(f"{k} {v:g}" for k, v in r["launches_per_step"].items()))
    log(f"[cli sampled] graphed tokens == eager tokens, bit for bit ({REPS} timed runs and the "
        f"capture run each, seed 0); the card over the runs: {card.line()}")
    same = generate(engines["chain"], 1, seed=1)[0] == eager["chain"]
    log(f"[cli] at the defaults seed 1 gives {'the same' if same else 'another'} chain stream "
        f"as seed 0 ({len(set(eager['chain']))} distinct tokens in it; logged only: on random "
        f"weights the defaults may leave one token per step, so the flat chain asserts it)")
    out["flat"] = flat_sampler_checks(eng, ids, generate)

    greedy_cfg = SamplerConfig(temperature=0.0, greedy=True)
    gen = engines["plain"]
    ref_toks, _ = generate(gen, 1, scfg=greedy_cfg)
    out["temp0"] = {}
    for kind in ("chain", "tree", "tree2"):
        e = eng.make_engine(kind, sampler=greedy_cfg)
        toks, stats = generate(e, 1)
        out["temp0"][kind] = dict(stats=stats, vs_plain=check_near_tie(
            gen, ids, ref_toks, toks, "cli temp 0", f"{kind} vs Generator"))
        if kind == "chain":
            text = tok.decode([t for t in toks if t != tok.eos_id], skip_special=True)
            if text != out["runs"]["temp 0"]["text"]:
                raise AssertionError("cli temp 0: the CLI's --temp 0 text differs from the "
                                     "in-process greedy chain's text")
            log("[cli temp 0] the CLI's --temp 0 text == the in-process greedy chain's text")
        del e
        torch.cuda.empty_cache()
    out["sampler_share_ms"] = sampler_share(report, res)
    out.update(variants=res, card_during_runs=card.summary, prompt_tokens=len(ids))
    report["cli_path"] = out
    del engines, eng
    torch.cuda.empty_cache()

# --------------------------------------------------------------------------
# phase chat: a conversation over the live cache on phase 6's files

CHAT_WORDS = (120, 60, 200)  # the three user turns
CHAT_NEW = 48  # new tokens per turn
CHAT_SHIFT_SEQ = 512  # the cache whose third turn shifts the context


def chat_texts(tokens: list) -> list[str]:
    return [cli_prompt(tokens, n, seed=20 + i) for i, n in enumerate(CHAT_WORDS)]


def chat_cli(target, draft, texts: list) -> str:
    """`python -m eagle_tpu_torch.tools.cli --chat --chat-template vicuna
    --temp 0` as a subprocess, the three turns on stdin: it must exit 0 and
    print a `[perf]` line per turn. Returns its stdout."""
    env = {k: v for k, v in os.environ.items() if k != "EAGLE_TPU_FUSED_FFN"}
    cmd = [sys.executable, "-m", "eagle_tpu_torch.tools.cli", "-m", str(target), "--draft",
           str(draft), "--chat", "--chat-template", "vicuna", "--temp", "0", "-n",
           str(CHAT_NEW)]
    t0 = time.time()
    p = subprocess.run(cmd, input="\n".join(texts) + "\n", cwd=pathlib.Path(__file__).resolve()
                       .parent, env=env, capture_output=True, text=True, timeout=600)
    perf = [ln for ln in p.stderr.splitlines() if ln.startswith("[perf]")]
    if p.returncode != 0 or len(perf) != len(texts):
        raise AssertionError(f"chat cli: exit {p.returncode}, stdout {p.stdout[-400:]!r}, "
                             f"stderr {p.stderr[-2000:]}")
    log(f"[chat cli] exit 0 in {time.time() - t0:.1f} s (load included); {' | '.join(perf)}")
    return p.stdout


def chat_turns(session, texts: list) -> list[dict]:
    """The session's turns, each timed: the feed's host ms (the turn's start
    to its first token, synchronized), its device ms (CUDA events around
    `Generator._extend`), its rows and launches, decode tokens/s after the
    first token, and the turn's tokens."""
    import torch

    from eagle_tpu_torch import _build

    gen = session.gen
    real = gen._extend
    rec: dict = {}

    def extend(*a, **k):
        before = dict(_build.launches)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = real(*a, **k)
        end.record()
        rec.update(events=(start, end), rows=a[0].shape[1], n=a[2], start=a[1], launches={
            n: c - before.get(n, 0) for n, c in _build.launches.items() if c != before.get(n, 0)})
        return out

    gen._extend = extend
    turns = []
    try:
        for text in texts:
            marks: dict = {"toks": []}

            def on_token(tok, marks=marks):
                if "first" not in marks:
                    torch.cuda.synchronize()
                    marks["first"] = time.perf_counter()
                marks["toks"].append(tok)

            torch.cuda.synchronize()
            t0 = time.perf_counter()
            session.ask(text, max_new_tokens=CHAT_NEW, on_token=on_token)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            first = marks.get("first", t1)
            n = len(session.last_out)
            turns.append(dict(out=list(session.last_out), streamed=marks["toks"],
                              context=list(session.fed[:session.last_prompt_len]),
                              rows=rec["rows"], n=rec["n"], start=rec["start"],
                              launches=rec["launches"], pos=session.pos,
                              feed_ms=(first - t0) * 1e3,
                              feed_device_ms=rec["events"][0].elapsed_time(rec["events"][1]),
                              decode_tps=(n - 1) / max(t1 - first, 1e-9)))
    finally:
        del gen._extend
    return turns


def chat_shift(eng, texts: list) -> dict:
    """A session on a 512-slot cache whose third turn shifts the context:
    graphed twice and eager once, the same tokens bit for bit; every shift
    keeps the cache's data pointers; in the second graphed run no graph is
    captured and no step runs eagerly, neither after its shift nor over the
    whole session; the shift's device ms by CUDA events."""
    import torch

    from eagle_tpu_torch.runtime.chat import ChatSession
    from eagle_tpu_torch.runtime.generate import Generator

    kw = dict(eng._engine_kw(), max_seq=CHAT_SHIFT_SEQ)
    graphed = Generator(eng.params, eng.model_cfg, **kw)
    eager = Generator(eng.params, eng.model_cfg, cuda_graphs=False, **kw)
    shifts: list = []

    def run(gen):
        real = gen.shift_context

        def shift(*a):
            ptrs = [x.data_ptr() for x in (gen.kv.k, gen.kv.v, gen.kv.slot_pos)]
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            real(*a)
            end.record()
            end.synchronize()
            if [x.data_ptr() for x in (gen.kv.k, gen.kv.v, gen.kv.slot_pos)] != ptrs:
                raise AssertionError("chat shift: the shift replaced the cache's tensors")
            shifts.append(dict(keep=a[0], discard=a[1], ms=start.elapsed_time(end),
                               host_ms=(time.perf_counter() - t0) * 1e3,
                               graphs=(gen.graphs.captures, gen.graphs.eager)))

        gen.shift_context = shift
        gen.kv.rollback(torch.zeros((1,), dtype=torch.int32, device="cuda"))
        s = ChatSession(gen, eng.tokenizer, template="vicuna")
        outs, n_fed = [], 0
        for text in texts:
            n_fed += len(s.turn_tokens(text))
            s.ask(text, max_new_tokens=CHAT_NEW)
            n_fed += len(s.last_out) - 1
            outs.append(list(s.last_out))
        del gen.shift_context
        if s.pos >= n_fed:
            raise AssertionError(f"chat shift: no context shift ({s.pos} of {n_fed} fed)")
        return outs

    first = run(graphed)
    before = (graphed.graphs.captures, graphed.graphs.eager)
    n_first = len(shifts)
    again = run(graphed)
    after = (graphed.graphs.captures, graphed.graphs.eager)
    at_shift = shifts[n_first]["graphs"]  # the second graphed run's first shift
    want = run(eager)
    if not first == again == want:
        raise AssertionError("chat shift: graphed and eager sessions differ")
    if after != at_shift:
        raise AssertionError(f"chat shift: the second graphed session captured after its shift "
                             f"(captures, eager bodies {at_shift} -> {after})")
    if after != before:
        raise AssertionError(f"chat shift: the second graphed session captured (captures, eager "
                             f"bodies {before} -> {after})")
    shift = shifts[n_first]
    log(f"[chat shift] max_seq {CHAT_SHIFT_SEQ}: {len(shifts) // 3} shift(s) per session (keep "
        f"{shift['keep']}, discard {shift['discard']}), {shift['ms']:.3f} ms of device time, "
        f"{shift['host_ms']:.3f} ms host; graphed (twice) == eager bit for bit; the cache kept "
        f"its pointers; the second graphed session captured nothing, after its shift or "
        f"before ({after[0]} graphs, {after[1]} eager bodies)")
    return dict(shifts=shifts, captures=after[0])


def chat_embed_check(tmp: pathlib.Path) -> dict:
    """`Engine.embed` (mean and last) and `rerank` on a 2-layer model of
    phase 2's widths (a tiny GGUF of this script's layout), f32, on the card
    against the CPU: relative error <= 1e-3."""
    import numpy as np
    import torch

    from eagle_tpu_torch.api import Engine, EngineConfig

    target, _ = mint_gguf_pair(tmp, seed=23, d=256, f=512, v=512, n_layers=2, n_heads=4,
                               tag="tiny")
    texts = ["the first text to embed", "a second one", "and a third, somewhat longer text"]
    out: dict = {}
    for dev in ("cuda", "cpu"):
        eng = Engine(EngineConfig(model_path=target, max_seq=128, compute_dtype=torch.float32,
                                  kv_dtype=torch.float32, device=dev))
        out[dev] = ([np.stack(eng.embed(texts, pooling=p)) for p in ("mean", "last")]
                    + [np.asarray(eng.rerank(texts[0], texts[1:]))])
    worst = 0.0
    for what, got, want in zip(("embed mean", "embed last", "rerank"), out["cuda"], out["cpu"]):
        _, rel = rel_err(torch.from_numpy(got), torch.from_numpy(want))
        if rel > TINY_TOL or not np.isfinite(got).all():
            raise AssertionError(f"chat: {what} on the card vs the CPU: rel err {rel:.3e}")
        worst = max(worst, rel)
    log(f"[chat embed] tiny 2-layer model, f32: embed (mean, last) and rerank on the card vs "
        f"the CPU: worst rel err {worst:.2e}")
    return dict(rel_err=worst)


def chat_server(eng, texts: list) -> dict:
    """The server (`-np 1`) on the loaded engine: /v1/embeddings and /rerank
    once each; 4,096-wide unit vectors, and the rerank's scores the
    in-process `Engine.rerank`'s, ranked."""
    import urllib.request

    import numpy as np

    from eagle_tpu_torch.server.server import InferenceServer

    srv = InferenceServer(eng, model_name="vicuna-7b-shape")
    host, port = srv.start("127.0.0.1", 0)

    def post(path, body):
        req = urllib.request.Request(f"http://{host}:{port}{path}", json.dumps(body).encode(),
                                     {"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as r:
            return json.loads(r.read())

    try:
        t0 = time.time()
        emb = post("/v1/embeddings", {"input": texts[1:]})
        docs = [texts[1], texts[0][:200], texts[2][:300]]
        rr = post("/rerank", {"query": texts[1][:200], "documents": docs})
        dt = time.time() - t0
    finally:
        srv.stop()
    vecs = [np.asarray(d["embedding"]) for d in emb["data"]]
    if [v.shape for v in vecs] != [(eng.model_cfg.n_embd,)] * 2 or \
            any(abs(np.linalg.norm(v) - 1) > 1e-3 or not np.isfinite(v).all() for v in vecs):
        raise AssertionError(f"chat server: embeddings {[v.shape for v in vecs]}")
    want = eng.rerank(texts[1][:200], docs)
    got = {r["index"]: r["relevance_score"] for r in rr["results"]}
    scores = [r["relevance_score"] for r in rr["results"]]
    if sorted(got) != [0, 1, 2] or scores != sorted(scores, reverse=True) or \
            max(abs(got[i] - want[i]) for i in got) > 1e-3:
        raise AssertionError(f"chat server: rerank {rr['results']} against {want}")
    log(f"[chat server] -np 1: /v1/embeddings (2 x {eng.model_cfg.n_embd}, unit norm) and "
        f"/rerank (scores {', '.join(f'{x:.4f}' for x in scores)}, as Engine.rerank) in "
        f"{dt:.2f} s")
    return dict(rerank=scores, seconds=dt)


def chat_path(report: dict, target, draft, tmp: pathlib.Path) -> dict:
    """The chat on phase 6's files (unfused, greedy, the vicuna template):
    the CLI's `--chat` as a subprocess; then in process `Engine.
    chat_session()` over three turns of ~120, 60 and 200 words, 48 new
    tokens each: graphed once to capture and 3 timed runs (`[chat]` lines:
    feed host ms, feed device ms, decode tokens/s per turn), the timed runs'
    and an eager session's tokens equal bit for bit, the CLI's output the
    session's stream; each feed 129 qmm_tc and 32 flash_prefill launches;
    each turn's tokens against one graphed `Generator.generate` over the
    conversation so far, up to a bf16 near-tie; `chat_shift`,
    `chat_embed_check` and `chat_server`. Returns the launch counts of the
    first timed session, counted from zero (the chat path)."""
    import gc

    import torch

    from eagle_tpu_torch import _build
    from eagle_tpu_torch.api import Engine, EngineConfig
    from eagle_tpu_torch.gguf import GGUFReader
    from eagle_tpu_torch.runtime.chat import ChatSession
    from eagle_tpu_torch.runtime.generate import Generator

    os.environ.pop("EAGLE_TPU_FUSED_FFN", None)
    with GGUFReader(target) as reader:
        texts = chat_texts(reader.metadata["tokenizer.ggml.tokens"])
    cli_out = chat_cli(target, draft, texts)
    eng = Engine(EngineConfig(model_path=target, draft_path=draft))
    tok = eng.tokenizer
    graphed = eng.chat_session(template="vicuna")
    if graphed.gen is not eng._plain_generator() or not graphed.gen.graphs.enabled:
        raise AssertionError("chat: the session is not on the engine's graphed Generator")

    def session(gen=None):
        if gen is None:
            graphed.gen.kv.rollback(torch.zeros((1,), dtype=torch.int32, device="cuda"))
            return eng.chat_session(template="vicuna")
        return ChatSession(gen, tok, template="vicuna")

    warm = chat_turns(session(), texts)  # captures the step graphs
    runs = []
    for i in range(3):
        _build.reset_counts()  # ---- the chat path: counts from here ----
        runs.append(chat_turns(session(), texts))
        if i == 0:
            launches = dict(_build.launches)  # ---- ends ----
    eager_gen = Generator(eng.params, eng.model_cfg, cuda_graphs=False, **eng._engine_kw())
    eager = chat_turns(session(eager_gen), texts)
    del eager_gen
    toks = [t["out"] for t in warm]
    for name, r in [("eager", eager)] + [(f"graphed run {i + 1}", r) for i, r in enumerate(runs)]:
        if [t["out"] for t in r] != toks:
            raise AssertionError(f"chat: the {name} session's tokens differ from the first's")
    stream = "".join("> " + "".join(tok.decode([t], skip_special=True) for t in turn["streamed"])
                     for turn in warm) + "> "
    if cli_out != stream:
        raise AssertionError(f"chat: the CLI printed {cli_out[:300]!r}..., the session "
                             f"{stream[:300]!r}...")
    feeds = [(t["rows"], t["n"], t["start"], graphed.gen.kv_read_bucket(t["start"] + t["rows"]))
             for t in warm]
    if feeds != CHAT_FEEDS:
        raise AssertionError(f"chat: the feeds {feeds} are not those phase 2 holds flash_prefill "
                             f"to ({CHAT_FEEDS})")
    for t, turn in enumerate(warm + eager):
        got = {k: turn["launches"].get(k, 0) for k in ("qmm_tc", "flash_prefill", "qmm_gemv")}
        if got != {"qmm_tc": PROMPT_QMM, "flash_prefill": 32, "qmm_gemv": 0}:
            raise AssertionError(f"chat: feed {t % 3 + 1} launched {turn['launches']}")
    for k in CORE_KERNELS[:2] + ("flash_decode", "flash_prefill"):
        if launches.get(k, 0) <= 0:
            raise AssertionError(f"chat: the path launched no {k}: {launches}")
    if any(_build.plain_calls.values()):
        raise AssertionError(f"chat: plain versions ran: {_build.plain_calls}")

    mono = Generator(eng.params, eng.model_cfg, **eng._engine_kw())
    ties = []
    for i, turn in enumerate(warm):
        want = mono.generate(turn["context"], max_new_tokens=len(turn["out"]),
                             stop_at_eos=False)
        ties.append(check_near_tie(mono, turn["context"], want, turn["out"], "chat",
                                   f"turn {i + 1} (a {turn['n']}-token feed at "
                                   f"{turn['start']}) vs one monolithic greedy run"))
    del mono
    out: dict = {"turns": []}
    for i in range(len(texts)):
        per = [r[i] for r in runs]
        row = dict(rows=warm[i]["rows"], n=warm[i]["n"], start=warm[i]["start"],
                   context=len(warm[i]["context"]), pos=warm[i]["pos"],
                   feed_ms=[p["feed_ms"] for p in per],
                   feed_device_ms=[p["feed_device_ms"] for p in per],
                   decode_tps=[p["decode_tps"] for p in per], eager_feed_ms=eager[i]["feed_ms"],
                   launches=warm[i]["launches"], near_tie=ties[i])
        out["turns"].append(row)
        log(f"[chat] turn {i + 1}: a {row['n']}-token feed at {row['start']} ({row['rows']}-row "
            f"bucket), then {len(toks[i])} tokens: feed {fmt(spread(row['feed_ms']))} ms host "
            f"to the first token, CUDA-event span {fmt(spread(row['feed_device_ms']), 3)} ms "
            f"(eager session {row['eager_feed_ms']:.1f} ms host); decode "
            f"{fmt(spread(row['decode_tps']))} t/s (3 graphed runs)")
    log(f"[chat] graphed == eager bit for bit over 3 turns; the CLI's replies equal the "
        f"session's; per feed {PROMPT_QMM} qmm_tc and 32 flash_prefill; chat path launches "
        f"{ {k: v for k, v in launches.items() if v} }")
    # the device's busy time in one feed: turn 2's again, at its offset (it
    # rewrites the same rows), traced
    t2 = warm[1]
    fed = torch.zeros((1, t2["rows"]), dtype=torch.int32, device="cuda")
    fed[0, :t2["n"]] = torch.tensor(t2["context"][-t2["n"]:], dtype=torch.int32)
    gen = graphed.gen
    out["feed_profile"] = profile_steps(
        lambda: gen._extend(fed, t2["start"], t2["n"], t2["rows"],
                            kv_limit=gen.kv_read_bucket(t2["start"] + t2["rows"])),
        1, f"feed of turn 2 ({t2['n']} tokens at {t2['start']})", "feed", tag="chat profile")
    out["shift"] = chat_shift(eng, texts)
    out["server"] = chat_server(eng, texts)
    # qmm of a feed at 16 to 256 rows on the served Q4_0 weights (the kernel
    # table's rows; the turns' feeds take 256 / 128 / 256; a feed's rows do
    # not depend on its offset)
    out["qmm"] = []
    rng = torch.Generator(device="cuda").manual_seed(19)
    for rows in (16, 32, 64, 128, 256):
        out[f"qmm per {rows}-row feed"] = qmm_sum("chat kernel", f"{rows}-row feed", rows,
                                                  target_qmm_specs(eng.params), "qmm_tc", rng,
                                                  out["qmm"])
    del eng, graphed, gen
    gc.collect()
    torch.cuda.empty_cache()
    out["embed"] = chat_embed_check(tmp)
    report["chat"] = out
    return launches


# --------------------------------------------------------------------------
# phase serve: continuous batching and the HTTP server on phase 6's files


SERVE_WORDS = (40, 150, 300, 700)  # the four requests' prompts, in vocabulary words
SERVE_SLOTS = 4
SERVE_NEW = 64  # new tokens per in-process request
SERVE_HTTP_NEW = 32  # n_predict of the HTTP requests
SERVE_STREAMS = (1, 2, 4)
#: the HTTP requests' prompts, in words: short, so that every cycle of them reads the
#: same attention bucket (128) whatever order the server admits them in; the batched
#: tokens of a row then depend on nothing of the other rows
SERVE_HTTP_WORDS = (24, 32, 40, 48)
SERVE_CHAT_WORDS = 8  # the chat request's one user message (chatml: the files carry no template)


def batch_run(b, prompts: list, n_new: int, stagger: bool = True, sampler=None,
              stop_at_eos: bool = False) -> list:
    """Each prompt through the batcher: two submitted, three steps, then the
    rest (or all at once), each as soon as a slot is free; returns each
    request's tokens."""
    toks: list = [[] for _ in prompts]
    waiting = list(range(len(prompts)))
    steps = 0
    while waiting or b.n_active or b.n_pending:
        while waiting and not (stagger and waiting[0] >= 2 and steps < 3):
            i = waiting[0]
            if b.submit(prompts[i], max_new_tokens=n_new, stop_at_eos=stop_at_eos,
                        sampler=sampler, on_token=toks[i].append) is None:
                break
            waiting.pop(0)
        b.step()
        steps += 1
    return toks


def stream_runs(b, ids: list, n: int) -> dict:
    """`n` concurrent requests of the same prompt, all submitted at once:
    aggregate tokens/s, each request's TTFT (submit to its first token,
    which the batcher reads on the host), the host's ms per step with every
    request generating (no prefill chunk in it)."""
    import torch

    first: dict = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    slots = [b.submit(ids, max_new_tokens=SERVE_NEW, stop_at_eos=False,
                      on_token=lambda _t, i=i: first.setdefault(i, time.perf_counter()))
             for i in range(n)]
    steps = []
    while b.n_active or b.n_pending:
        full = b.n_pending == 0 and b.n_active == n
        s0 = time.perf_counter()
        b.step()
        if full:
            steps.append((time.perf_counter() - s0) * 1e3)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_tok = sum(len(s.generated) for s in slots)
    return dict(tokens_per_s=n_tok / wall, ttft_ms=[(first[i] - t0) * 1e3 for i in range(n)],
                step_ms=sorted(steps)[len(steps) // 2], steps=len(steps), tokens=n_tok)


def batched_cycle_device(b, ids: list) -> dict:
    """Device ms per batched cycle at B = 4 with every row generating: CUDA
    events over 8 back-to-back replays of the masked cycle (the graph
    the steps replay), and the launches of one replay."""
    from eagle_tpu_torch import _build

    ce = b.engine
    for i in range(SERVE_SLOTS):
        b.submit(ids, max_new_tokens=10_000, stop_at_eos=False, request_id=f"timed {i}")
    while b.n_pending:
        b.step()
    b.step()
    lim = ce.kv_read_bucket(int(b.n_past.max()) + 9 * (ce.K + 1) + ce.K + 2)
    warm = ce.graphs.eager

    def cycles(n):
        for _ in range(n):
            ce._multi_cycle(1, kv_limit=lim, active=b._active_mask)

    cycles(1)  # the bucket's graph, if the runs have not captured it
    out = timed_events(lambda: cycles(8), 8)
    out["captured_here"] = ce.graphs.eager - warm
    _build.reset_counts()
    cycles(1)
    out["launches"] = {k: v for k, v in _build.launches.items() if v}
    out["plain_calls"] = {k: v for k, v in _build.plain_calls.items() if v}
    for i in range(SERVE_SLOTS):
        b.abort(f"timed {i}")
    return out


def spec_k_check(b, ids: list, greedy: list, gen) -> dict:
    """One spec_k = 1 slot beside two spec_k = 5 slots of the same prompt,
    eagerly, with an oracle draft (`oracle_forward`: it proposes the greedy
    continuation, so uncapped rows accept the full depth): every row's
    tokens equal the greedy ones up to the near-tie rule, the capped row
    accepts at most 1 draft per cycle and an uncapped one 5 at least once."""
    import torch

    from eagle_tpu_torch.runtime import speculative

    ce = b.engine
    seq = torch.tensor(list(ids) + greedy, dtype=torch.int64, device="cuda")
    real, graphed = speculative.eagle_forward, ce.graphs.enabled
    speculative.eagle_forward = oracle_forward(real, seq)
    ce.graphs.enabled = False
    try:
        slots = [b.submit(ids, max_new_tokens=SERVE_NEW, stop_at_eos=False, spec_k=k)
                 for k in (1, 5, 5)]
        most = [0, 0, 0]  # the cap holds on every row, active or not
        ce._outs[1].n_accepted.zero_()
        while b.n_active or b.n_pending:
            b.step()
            acc = ce._outs[1].n_accepted[0].tolist()
            most = [max(m, acc[s.id]) for m, s in zip(most, slots)]
    finally:
        speculative.eagle_forward = real
        ce.graphs.enabled = graphed
    for i, s in enumerate(slots):
        check_near_tie(gen, ids, greedy, s.generated, "serve spec_k",
                       f"spec_k {(1, 5, 5)[i]} slot (oracle draft) vs the single-sequence chain")
    if most[0] > 1 or max(most[1:]) != ce.K:
        raise AssertionError(f"spec_k: most drafts accepted per cycle {most} (capped row "
                             f"first), expected <= 1 and {ce.K}")
    log(f"[serve] spec_k: the spec_k = 1 slot accepts at most {most[0]} draft per cycle, the "
        f"spec_k = 5 slots {most[1:]} (oracle draft); every slot's tokens the greedy ones")
    return dict(most_accepted=most)


def serve_http(target, draft, prompts: list, chat: list, want: dict, tmp: pathlib.Path
               ) -> dict:
    """`python -m eagle_tpu_torch.server.server -m target --draft draft -np 4`
    as a subprocess: four concurrent /completion requests (temperature 0,
    n_predict 32) and one streamed /v1/chat/completions; each content must
    equal the in-process batcher's text, the stream's chunks must join to
    the in-process tokens' pieces (the server streams each token's piece, as
    the reference: a byte token that is not whole UTF-8 streams as "", where
    the text decodes the bytes together), /metrics must count 5 requests,
    and SIGTERM must end the server with exit 0 and no traceback on its
    stderr."""
    import concurrent.futures
    import signal
    import socket
    import urllib.request

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    base = f"http://127.0.0.1:{port}"
    env = {k: v for k, v in os.environ.items() if k != "EAGLE_TPU_FUSED_FFN"}
    err_path = tmp / "server.stderr"
    t0 = time.time()
    with open(err_path, "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m", "eagle_tpu_torch.server.server", "-m", str(target),
             "--draft", str(draft), "-np", str(SERVE_SLOTS), "--host", "127.0.0.1",
             "--port", str(port)],
            cwd=pathlib.Path(__file__).resolve().parent, env=env, stdout=subprocess.DEVNULL,
            stderr=err)
    try:
        while True:
            if proc.poll() is not None:
                raise AssertionError(f"server exited {proc.returncode} before it answered: "
                                     f"{err_path.read_text()[-3000:]}")
            try:
                urllib.request.urlopen(base + "/health", timeout=2)
                break
            except OSError:
                if time.time() - t0 > 300:
                    raise
                time.sleep(0.25)
        up_s = time.time() - t0

        def post(path, body):
            req = urllib.request.Request(base + path, json.dumps(body).encode(),
                                         {"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=300) as r:
                return r.read().decode()

        t1 = time.time()
        with concurrent.futures.ThreadPoolExecutor(5) as ex:
            completions = [ex.submit(post, "/completion", {
                "prompt": p, "n_predict": SERVE_HTTP_NEW, "temperature": 0}) for p in prompts]
            stream = ex.submit(post, "/v1/chat/completions", {
                "messages": chat, "max_tokens": SERVE_HTTP_NEW, "temperature": 0,
                "stream": True})
            contents = [json.loads(f.result())["content"] for f in completions]
            frames = [ln[6:] for ln in stream.result().split("\n") if ln.startswith("data: ")]
        requests_s = time.time() - t1
        for i, (got, exp) in enumerate(zip(contents, want["completions"])):
            if got != exp:
                raise AssertionError(f"/completion {i}: {got[:200]!r} != the in-process "
                                     f"batcher's {exp[:200]!r}")
        if frames[-1] != "[DONE]":
            raise AssertionError(f"the chat stream did not end with [DONE]: {frames[-3:]}")
        joined = "".join(json.loads(f)["choices"][0]["delta"].get("content", "")
                         for f in frames[:-1])
        if joined != want["chat_pieces"]:
            raise AssertionError(f"streamed chat {joined[:200]!r} != the in-process tokens' "
                                 f"pieces {want['chat_pieces'][:200]!r}")
        with urllib.request.urlopen(base + "/metrics", timeout=30) as r:
            metrics = dict(line.split() for line in r.read().decode().splitlines()
                           if line and not line.startswith("#"))
        if metrics["eagle_tpu_requests_total"] != "5":
            raise AssertionError(f"/metrics counts {metrics['eagle_tpu_requests_total']} "
                                 f"requests, not 5")
    finally:
        if proc.poll() is None:
            proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    stderr = err_path.read_text()
    if proc.returncode != 0 or "Traceback" in stderr:
        raise AssertionError(f"server: exit {proc.returncode} after SIGTERM, stderr "
                             f"{stderr[-3000:]}")
    log(f"[serve http] the server answered /health {up_s:.1f} s after its start (load "
        f"included); 4 concurrent /completion + 1 streamed chat in {requests_s:.2f} s: every "
        f"content == the in-process batcher's text, the {len(frames) - 2} streamed chunks join "
        f"to its chat tokens' pieces (== its chat text: {want['chat_pieces'].strip() == want['chat']}"
        f"), /metrics counts 5 requests; SIGTERM: exit 0, stderr "
        f"{' | '.join(stderr.split(chr(10))[-3:]).strip()!r}")
    return dict(up_s=up_s, requests_s=requests_s, metrics=metrics,
                stream_frames=len(frames))


def target_qmm_specs(params) -> list:
    """(name, weight, launches) of a target forward's products: the four
    stacked projections of each layer (wqkv and wo of a MoE layer, whose
    experts are dense products) and lm_head (none for a tied "nk" head,
    which is no qmm)."""
    tl = params["layers"]
    n_layers = tl["wqkv"].q.shape[0]
    head = [] if params["output"].layout == "nk" else [("lm_head", params["output"], 1)]
    if "ffn_gate_inp" in tl:  # the experts are dense products, no qmm
        return [(n, tl[n], n_layers) for n in ("wqkv", "wo")] + head
    ffn_in = "w_gate_up" if "w_gate_up" in tl else "w_up"  # the no-gate MLP's up
    return [(n, tl[n], n_layers) for n in ("wqkv", "wo", ffn_in, "w_down")] + head


def qmm_sum(tag: str, what: str, rows: int, specs: list, route: str, gen,
            results: list) -> dict:
    """qmm at `rows` rows for each (name, weight, launches) of `specs`, held
    against its plain version (rel err <= 1e-2) and asserted to take `route`,
    then timed: kernel, plain, bound and library ms. Stacked weights cycle
    over the layers (the library over 4 dequantized layers) so that repeats
    do not hit in the L2; a single layer cannot. Each call's result goes to
    `results`; returns the sums over the launches of one `what`."""
    import torch

    from eagle_tpu_torch import _build
    from eagle_tpu_torch.ops.qmm import qmm, qmm_plain, qmm_stacked

    total = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0}
    for name, w, count in specs:
        stack = w.q.shape[0] if w.q.dim() == 3 else 0
        layers = [w.layer(i) for i in range(min(stack, 4))] if stack else [w]
        n, k = layers[0].shape
        x = torch.randn((rows, k), generator=gen, device="cuda")
        _build.reset_counts()
        got = qmm_stacked(x, w, 0) if stack else qmm(x, w)
        if _build.launches[route] != 1:
            raise AssertionError(f"{tag} qmm {name} rows={rows}: not {route}")
        abs_err, rel = rel_err(got, qmm_plain(x, layers[0]))
        if rel > QMM_TOL or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{tag} qmm {name} rows={rows}: rel err {rel:.3e}")
        if stack:
            ms = device_ms(lambda i: qmm_stacked(x, w, i % stack), max(2 * stack, 20))
        else:
            ms = device_ms(lambda i: qmm(x, w), 20)
        plain = device_ms(lambda i: qmm_plain(x, layers[i % len(layers)]), 3, warmup=1)
        dense = [lw.dequantize(torch.bfloat16).T.contiguous() for lw in layers]
        xb = x.to(torch.bfloat16)
        lib = device_ms(lambda i: torch.matmul(xb, dense[i % len(dense)]), 20)
        del dense
        b_ms, b_by = bound_ms(nbytes(*layers[0].tensors().values()) + rows * k * 4
                              + rows * n * 4, 2.0 * rows * k * n)
        res = dict(name=name, rows=rows, route=route, ms=ms, plain_ms=plain, bound_ms=b_ms,
                   bound_by=b_by, library_ms=lib, max_abs_err=abs_err, rel_err=rel,
                   per=what, count=count)
        results.append(res)
        for key in total:
            total[key] += count * res[key]
        log(f"[{tag}] qmm {name:22s} N={n:5d} K={k:5d} rows={rows:2d} ({route})  "
            f"kernel {ms:.4f} ms  plain {plain:.3f} ms  bound {b_ms * 1e3:.2f} us ({b_by})  "
            f"library {lib:.4f} ms  rel err {rel:.2e}")
    log(f"[{tag}] qmm per {what} ({sum(c for _, _, c in specs)} launches, {rows} "
        f"rows): kernel {total['ms']:.3f} ms, bound {total['bound_ms']:.3f} ms, plain "
        f"{total['plain_ms']:.3f} ms, library {total['library_ms']:.3f} ms")
    torch.cuda.empty_cache()
    return total


def serve_kernels(eng) -> dict:
    """The kernels at the serving shapes, on the served Q4_0 / Q8_0 weights
    (kernel ms, plain ms, bound and library ms, rel err <= 1e-2): qmm of the
    batched verify (24 rows: `qmm_tc`), of a draft step at 4 rows
    (`qmm_mma`) and of a 64-row prompt chunk (`qmm_tc`), with their sums
    per cycle and per chunk (`qmm_sum`); flash_decode at B = 4, T = 6 over a
    cache of the batcher's shape (2,048 + spill slots, s_limit 512, four
    rows at n_past 301-360)."""
    import torch
    import torch.nn.functional as F

    from eagle_tpu_torch.ops import flash_attention as fa
    from eagle_tpu_torch.runtime.kvcache import causal_mask_from_tags

    gen = torch.Generator(device="cuda").manual_seed(17)
    dl = eng.draft_params["layers"]
    target = target_qmm_specs(eng.params)
    draft = ([("fc_w (draft)", eng.draft_params["fc_w"], 1)]
             + [(f"{n} (draft)", dl[n], 1) for n in ("wqkv", "wo", "w_gate_up", "w_down")]
             + [("lm_head (draft step)", eng.params["output"], 1)])
    out: dict = {"qmm": []}
    for what, rows, specs, route in (("verify", 4 * 6, target, "qmm_tc"),
                                     ("draft step", 4, draft, "qmm_mma"),
                                     ("prompt chunk", 64, target, "qmm_tc")):
        out[f"qmm per {what}"] = qmm_sum("serve kernel", what, rows, specs, route, gen,
                                         out["qmm"])

    b, t, h, d, s, lim = 4, 6, 32, 128, 2048 + 2 * (eng.engine.K + 1), 512
    k_cache = torch.randn((2, b, h, s, d), generator=gen, device="cuda").to(torch.bfloat16)
    v_cache = torch.randn((2, b, h, s, d), generator=gen, device="cuda").to(torch.bfloat16)
    n_past = torch.tensor([301, 320, 340, 360], dtype=torch.int32, device="cuda")
    pos = n_past[:, None] + torch.arange(t, dtype=torch.int32, device="cuda")[None]
    slots = torch.arange(s, dtype=torch.int32, device="cuda")[None].repeat(b, 1)
    tags = torch.where(slots < (n_past[:, None] + t), slots, -1)
    mask = causal_mask_from_tags(tags[:, :lim], pos)
    q = torch.randn((b, t, h, d), generator=gen, device="cuda")
    got = fa.flash_attention_cached(q, k_cache, v_cache, mask, 1, s_limit=lim)
    abs_err, rel = rel_err(got, fa.flash_attention_cached_plain(q, k_cache, v_cache, mask, 1,
                                                                 s_limit=lim))
    if rel > ATTN_TOL or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"serve flash_decode B=4 T=6: rel err {rel:.3e}")
    ms = device_ms(lambda i: fa.flash_attention_cached(q, k_cache, v_cache, mask, i % 2,
                                                       s_limit=lim), 50)
    plain = device_ms(lambda i: fa.flash_attention_cached_plain(q, k_cache, v_cache, mask,
                                                               i % 2, s_limit=lim), 10)
    qb = q.transpose(1, 2).to(torch.bfloat16)
    kl, vl = k_cache[1, :, :, :lim], v_cache[1, :, :, :lim]
    lib = device_ms(lambda i: F.scaled_dot_product_attention(qb, kl, vl,
                                                             attn_mask=mask[:, None]), 50)
    b_ms, b_by = bound_ms(2 * b * h * lim * d * 2 + nbytes(q, mask) + q.numel() * 4,
                          4.0 * b * h * t * lim * d)
    out["flash_decode"] = dict(b=b, t=t, s_limit=lim, ms=ms, plain_ms=plain, bound_ms=b_ms,
                               bound_by=b_by, library_ms=lib, max_abs_err=abs_err, rel_err=rel)
    log(f"[serve kernel] flash_decode B={b} T={t} S={lim} H={h} D={d} (a batch-row stride of "
        f"{s} slots)  kernel {ms:.4f} ms  plain {plain:.4f} ms  bound {b_ms * 1e3:.2f} us "
        f"({b_by})  library {lib:.4f} ms  rel err {rel:.2e}")
    del k_cache, v_cache
    torch.cuda.empty_cache()
    return out


def serve_path(report: dict, target, draft, tmp: pathlib.Path) -> dict:
    """Continuous batching on the card, at full Vicuna-7B width and depth on
    phase 6's files (unfused, K = 5, greedy): `Engine(batch=4)` and its
    `ContinuousBatcher`. Four prompts of about 40, 150, 300 and 700 tokens,
    two submitted, three steps, then the other two, 64 new tokens each:
    each slot's tokens equal the graphed single-sequence chain's up to the
    near-tie rule; a second graphed run gives the same tokens with no eager
    body; the eager batched run the same tokens bit for bit. Then 1, 2 and
    4 concurrent requests of the 300-token prompt, 2 runs each (`[serve]`
    lines: aggregate tokens/s, TTFT per request, the host's ms per step),
    the device ms per batched cycle at B = 4 (CUDA events over replays),
    the idle share and the launches per cycle; the spec_k check
    (`spec_k_check`); then the texts of the HTTP requests in process, the
    engine freed, and `serve_http`. Returns the 4-stream runs' launches."""
    import gc

    import torch

    from eagle_tpu_torch import _build
    from eagle_tpu_torch.api import Engine, EngineConfig
    from eagle_tpu_torch.gguf import GGUFReader
    from eagle_tpu_torch.runtime.speculative import EagleChainEngine
    from eagle_tpu_torch.server.chat_templates import apply_template
    from eagle_tpu_torch.utils.args import sampler_from_request

    os.environ.pop("EAGLE_TPU_FUSED_FFN", None)
    with GGUFReader(target) as reader:
        vocab = reader.metadata["tokenizer.ggml.tokens"]
    texts = [cli_prompt(vocab, n, seed=20 + i) for i, n in enumerate(SERVE_WORDS)]
    t0 = time.time()
    eng = Engine(EngineConfig(model_path=target, draft_path=draft, batch=SERVE_SLOTS,
                              max_seq=2048))
    torch.cuda.synchronize()
    out: dict = {"load_s": time.time() - t0}
    tok, b, ce = eng.tokenizer, eng.batcher, eng.engine
    prompts = [tok.encode(t) for t in texts]
    out["prompt_tokens"] = [len(p) for p in prompts]
    log(f"[serve] Engine(batch={SERVE_SLOTS}, max_seq 2048, greedy, K = {ce.K}) and its "
        f"ContinuousBatcher loaded in {out['load_s']:.1f} s; prompts of {out['prompt_tokens']} "
        f"tokens; device memory allocated {torch.cuda.memory_allocated() / 2**30:.2f} GiB")

    single = EagleChainEngine(eng.params, eng.draft_params, eng.model_cfg, eng.draft_cfg,
                              n_draft=ce.K, max_seq=2048, feature_source=eng.cfg.feature_source,
                              eos_id=tok.eos_id)
    want = [single.generate(p, SERVE_NEW, stop_at_eos=False)[0] for p in prompts]
    del single
    gen = eng._plain_generator()
    got = batch_run(b, prompts, SERVE_NEW)  # captures the masked cycle's graphs
    ties = [check_near_tie(gen, p, w, g, "serve", f"slot of the {len(p)}-token prompt vs the "
                           "graphed single-sequence chain")
            for p, w, g in zip(prompts, want, got)]
    warm = ce.graphs.eager
    if batch_run(b, prompts, SERVE_NEW) != got or ce.graphs.eager != warm:
        raise AssertionError("serve: a second graphed batched run gave other tokens or ran a "
                             "body eagerly")
    ce.graphs.enabled = False
    eager = batch_run(b, prompts, SERVE_NEW)
    ce.graphs.enabled = True
    if eager != got:
        raise AssertionError("serve: batched graphed tokens differ from batched eager tokens")
    log(f"[serve] batched graphed == batched eager, bit for bit ({SERVE_SLOTS} slots, staggered "
        f"submission, {SERVE_NEW} tokens each); a second graphed run: the same tokens, no eager "
        f"body; {ce.graphs.captures} graphs captured")
    out.update(near_ties=ties, graphs_captured=ce.graphs.captures)
    out["prompt_301"] = dict(ids=prompts[2], dense_batched=got[2], single=want[2])

    mid = prompts[2]
    for n in SERVE_STREAMS:  # the warm-up: the graphs of the runs' buckets
        stream_runs(b, mid, n)
    warm = ce.graphs.eager
    runs: dict = {}
    card = CardSampler()
    with card:
        for n in SERVE_STREAMS:
            if n == SERVE_STREAMS[-1]:
                _build.reset_counts()
            runs[n] = [stream_runs(b, mid, n) for _ in range(REPS)]
            if n == SERVE_STREAMS[-1]:
                launches = dict(_build.launches)
                if any(_build.plain_calls.values()):
                    raise AssertionError(f"serve: plain versions ran: {_build.plain_calls}")
    if ce.graphs.eager != warm:
        raise AssertionError("serve: a body ran eagerly in the timed runs")
    dev = batched_cycle_device(b, mid)
    per = dev["launches"]
    want_per = {"qmm_tc": VERIFY_QMM, "qmm_mma": 6 * ce.K, "flash_decode": 32 + ce.K}
    if any(per.get(k, 0) != v for k, v in want_per.items()) or dev["plain_calls"] or \
            per.get("qmm_gemv", 0):
        raise AssertionError(f"serve: launches per batched cycle {per}, expected {want_per} "
                             f"and no qmm_gemv or plain version")
    out["streams"] = {}
    for n, rs in runs.items():
        r = dict(tokens_per_s=spread([x["tokens_per_s"] for x in rs]),
                 step_ms=spread([x["step_ms"] for x in rs]),
                 ttft_ms=[x["ttft_ms"] for x in rs])
        r["idle_share"] = 1 - dev["ms"] / r["step_ms"]["median"]
        out["streams"][n] = r
        log(f"[serve] {n} concurrent request(s) of the {len(mid)}-token prompt, {SERVE_NEW} "
            f"tokens each: aggregate tokens/s min / median / max {fmt(r['tokens_per_s'])}; TTFT "
            f"ms per request (submit to first token, run 1) "
            f"{', '.join(f'{t:.1f}' for t in r['ttft_ms'][0])}; host ms per step with every "
            f"request generating {fmt(r['step_ms'])}; idle {100 * r['idle_share']:.1f}% of a "
            f"step against the device ms of a batched cycle")
    log(f"[serve] batched cycle at B = {SERVE_SLOTS}, every row generating: device "
        f"{dev['ms']:.3f} ms (CUDA events over 8 replays; enqueue {dev['enqueue_ms']:.3f} ms); "
        f"launches per cycle: " + ", ".join(f"{k} {v}" for k, v in sorted(per.items()))
        + f" ({VERIFY_QMM} qmm_tc: the {SERVE_SLOTS * (ce.K + 1)}-row verify; "
          f"{6 * ce.K} qmm_mma: {ce.K} draft steps at {SERVE_SLOTS} rows); the card over the "
          f"stream runs: {card.line()}")
    out.update(cycle_device=dev, card_during_runs=card.summary)
    out["spec_k"] = spec_k_check(b, mid, want[2], gen)
    out["kernels"] = serve_kernels(eng)

    # the HTTP requests' texts, in process, as the server will run them
    greedy = sampler_from_request({"temperature": 0}, eng.cfg.sampler)
    http_texts = [cli_prompt(vocab, n, seed=40 + i) for i, n in enumerate(SERVE_HTTP_WORDS)]
    chat = [{"role": "user", "content": cli_prompt(vocab, SERVE_CHAT_WORDS, seed=50)}]
    http_ids = [tok.encode(t) for t in http_texts] + [tok.encode(apply_template(chat))]
    toks = batch_run(b, http_ids, SERVE_HTTP_NEW, stagger=False, sampler=greedy,
                     stop_at_eos=True)
    if max(len(p) for p in http_ids) + SERVE_HTTP_NEW + 2 * ce.K + 4 > 128:
        raise AssertionError("serve: the HTTP prompts leave the 128-slot attention bucket")

    def text(t):
        return tok.decode([x for x in t if x != tok.eos_id], skip_special=True)

    want_http = {"completions": [text(t) for t in toks[:4]], "chat": text(toks[4]).strip(),
                 "chat_pieces": "".join(tok.piece(t) for t in toks[4] if t != tok.eos_id)}
    del eng, b, ce, gen
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[serve] the engine freed: device memory allocated "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    out["http"] = serve_http(target, draft, http_texts, chat, want_http, tmp)
    report["serve_path"] = out
    return launches


# --------------------------------------------------------------------------
# phase paged: the paged pool, prefix reuse, int8 caches, slot files, sessions,
# Self-Extend and the paged server, on phase 6's files


PAGED_PAGES = 64  # target pool pages of PAGE_ROWS rows: 2x oversubscribed at 4 x 2,048
PAGE_ROWS = 64
PAGED_CHECK_NEW = 16  # new tokens of the eager-vs-graphed and int8 checks
PREFIX_TOKENS, SUFFIX_TOKENS = 256, 45  # phase paged's shared-prefix requests
#: the qmm_tc launches of one 64-row prompt chunk: the target's forward (128
#: per-layer products + lm_head) and the draft's pass over the chunk (fc and
#: its layer's four products; no lm_head)
CHUNK_QMM = 129 + 5


def paged_streams(b, ids, n: int, n_new: int = SERVE_NEW) -> dict:
    """`n` concurrent requests of `ids`, all submitted at once (`stream_runs`,
    also returning each request's tokens and the most pool pages held)."""
    import torch

    first: dict = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    slots = [b.submit(ids, max_new_tokens=n_new, stop_at_eos=False,
                      on_token=lambda _t, i=i: first.setdefault(i, time.perf_counter()))
             for i in range(n)]
    steps, peak = [], 0
    while b.n_active or b.n_pending:
        full = b.n_pending == 0 and b.n_active == n
        s0 = time.perf_counter()
        b.step()
        if full:
            steps.append((time.perf_counter() - s0) * 1e3)
        peak = max(peak, b.pages_in_use()["tgt"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_tok = sum(len(s.generated) for s in slots)
    return dict(tokens_per_s=n_tok / wall, ttft_ms=[(first[i] - t0) * 1e3 for i in range(n)],
                step_ms=sorted(steps)[len(steps) // 2] if steps else None, tokens=n_tok,
                generated=[list(s.generated) for s in slots], peak_pages=peak)


def prefix_runs(b, prompts: list, cache: bool) -> dict:
    """The shared-prefix requests with the prefix cache on or off: the first
    alone until its prompt is in (registered when on), then the other three
    at once; TTFT per request (submit to its first token) and the tokens."""
    import torch

    b.prefix_cache = cache
    before = dict(b.stats)
    first, t_sub = {}, {}

    def submit(i):
        torch.cuda.synchronize()
        t_sub[i] = time.perf_counter()
        return b.submit(prompts[i], max_new_tokens=SERVE_NEW, stop_at_eos=False,
                        on_token=lambda _t, i=i: first.setdefault(i, time.perf_counter()))

    slots = [submit(0)]
    while slots[0].state != "generating":
        b.step()
    slots += [submit(i) for i in range(1, len(prompts))]
    b.run_until_done(max_steps=10_000)
    torch.cuda.synchronize()
    return dict(ttft_ms=[(first[i] - t_sub[i]) * 1e3 for i in range(len(prompts))],
                generated=[list(s.generated) for s in slots],
                stats={k: b.stats[k] - before[k] for k in b.stats})


def eager_tokens(eng, run):
    """run() with the engine's graphs off (every body eager)."""
    eng.graphs.enabled = False
    try:
        return run()
    finally:
        eng.graphs.enabled = True


def decode_device_ms(gen, ids: list, steps: int = 16) -> float:
    """Device ms per graphed decode step of `gen` after `ids` (CUDA events
    over `steps` replays at the read bucket `generate` takes there)."""
    import torch

    from eagle_tpu_torch.runtime.sampling import SamplerConfig

    out = gen.generate(ids, max_new_tokens=2, stop_at_eos=False)
    tok = torch.tensor([out[-1]], dtype=torch.int32, device="cuda")
    scfg, pos = SamplerConfig(greedy=True), len(ids) + 1
    lim = gen.kv_read_bucket(pos + steps)
    gen._decode_chunk(tok, pos, scfg, steps, kv_limit=lim)  # the bucket's graph
    eager = gen.graphs.eager
    ms = timed_events(lambda: gen._decode_chunk(tok, pos, scfg, steps, kv_limit=lim), steps)
    if gen.graphs.eager != eager:
        raise AssertionError("a decode step ran eagerly while it was timed")
    return ms["ms"]


def int8_checks(eng, gen, ids: list, bf16_paged: list) -> dict:
    """(c): the int8 pool (`Engine(..., paged=True, kv_dtype=torch.int8)`) and
    the dense chain engine and `Generator` at int8 on the 301-token prompt:
    graphed == eager bit for bit; the first divergence from bf16 (step and
    margin); device ms per batched cycle, per chain cycle and per decode
    step against bf16."""
    import gc

    import torch

    from eagle_tpu_torch.api import Engine, EngineConfig
    from eagle_tpu_torch.runtime.generate import Generator
    from eagle_tpu_torch.runtime.speculative import EagleChainEngine

    cfg = dataclasses.replace(eng.cfg, kv_dtype=torch.int8)
    e8 = Engine(cfg)
    b8, c8 = e8.batcher, e8.engine
    b8.prefix_cache = False
    got = paged_streams(b8, ids, 4, PAGED_CHECK_NEW)["generated"]  # captures
    eager = eager_tokens(c8, lambda: paged_streams(b8, ids, 4, PAGED_CHECK_NEW)["generated"])
    if got != eager:
        raise AssertionError("paged int8: graphed and eager tokens differ")
    out: dict = {"paged_vs_bf16": first_divergence(
        gen, ids, bf16_paged[:PAGED_CHECK_NEW], got[0], "paged int8",
        "the int8 pool's slot vs the bf16 pool's")}
    out["cycle"] = batched_cycle_device(b8, ids)
    per = out["cycle"]["launches"]
    if per.get("qmm_tc", 0) != VERIFY_QMM or per.get("flash_decode", 0):
        raise AssertionError(f"paged int8: launches per batched cycle {per}")
    del e8, b8, c8
    gc.collect()
    torch.cuda.empty_cache()

    spec = (eng.params, eng.draft_params, eng.model_cfg, eng.draft_cfg)
    chains, gens = {}, {}
    for name, dt in (("bf16", torch.bfloat16), ("int8", torch.int8)):
        chains[name] = EagleChainEngine(*spec, n_draft=5, max_seq=2048, kv_dtype=dt,
                                        feature_source=eng.cfg.feature_source,
                                        eos_id=eng.tokenizer.eos_id)
        gens[name] = Generator(eng.params, eng.model_cfg, max_seq=2048, kv_dtype=dt,
                               eos_id=eng.tokenizer.eos_id)
    c8 = chains["int8"]
    g1 = c8.generate(ids, PAGED_CHECK_NEW, stop_at_eos=False)[0]
    e1 = eager_tokens(c8, lambda: c8.generate(ids, PAGED_CHECK_NEW, stop_at_eos=False)[0])
    if g1 != e1:
        raise AssertionError("dense int8 chain: graphed and eager tokens differ")
    bf = chains["bf16"].generate(ids, PAGED_CHECK_NEW, stop_at_eos=False)[0]
    out["chain_vs_bf16"] = first_divergence(gen, ids, bf, g1, "paged int8",
                                            "the dense int8 chain vs the bf16 chain")
    for name in chains:
        chains[name].generate(ids, 2, stop_at_eos=False)
        lim = chains[name].kv_read_bucket(len(ids) + 8 * 7)
        chains[name]._multi_cycle(1, kv_limit=lim)  # the bucket's graph
        out[f"chain_cycle_ms_{name}"] = cycle_device_ms(chains[name], ids, 1)["ms"]
        out[f"decode_ms_{name}"] = decode_device_ms(gens[name], ids)
    log(f"[paged int8] the int8 pool (4 streams, {PAGED_CHECK_NEW} tokens) and the dense "
        f"int8 chain: graphed == eager bit for bit; device ms per batched cycle "
        f"{out['cycle']['ms']:.3f} (launches {per}); per chain cycle int8 "
        f"{out['chain_cycle_ms_int8']:.3f} vs bf16 {out['chain_cycle_ms_bf16']:.3f}; per decode "
        f"step int8 {out['decode_ms_int8']:.3f} vs bf16 {out['decode_ms_bf16']:.3f}")
    del chains, gens, c8
    gc.collect()
    torch.cuda.empty_cache()
    return out


def slot_checks(eng, ids: list, tmp: pathlib.Path) -> dict:
    """(d): a slot saved mid-stream (20 tokens of 64) in the paged batcher,
    restored into a fresh paged batcher and into a dense one over the same
    engine, resumed: the uninterrupted run's tokens, bit for bit in the
    paged batcher, up to the near-tie rule in the dense one (whose cycle
    reads the rows through flash_decode, the pool through the plain read,
    each as the reference's engines read them). Then the
    prompt-cache session in process: TTFT of the first run (the whole prompt)
    and of the second (the session's prefix reused)."""
    import torch

    from eagle_tpu_torch.runtime.paged_batcher import PagedBatcher
    from eagle_tpu_torch.runtime.scheduler import ContinuousBatcher

    b, ce = eng.batcher, eng.engine
    s = b.submit(ids, max_new_tokens=SERVE_NEW, stop_at_eos=False)
    while len(s.generated) < 20:
        b.step()
    path = tmp / "paged_slot.bin"
    t0 = time.perf_counter()
    b.save_slot(s.id, path)
    save_ms = (time.perf_counter() - t0) * 1e3
    b.run_until_done()
    want = list(s.generated)
    out = {"save_ms": save_ms, "file_mb": path.stat().st_size / 2**20}
    for name, nb in (("paged", lambda: PagedBatcher(ce, n_pages=PAGED_PAGES,
                                                    page_size=PAGE_ROWS)),
                     ("dense", lambda: ContinuousBatcher(ce))):
        b2 = nb()
        t0 = time.perf_counter()
        r = b2.restore_slot(path, slot_id=2)
        out[f"restore_ms_{name}"] = (time.perf_counter() - t0) * 1e3
        b2.resume_slot(2)
        b2.run_until_done()
        if name == "paged" and r.generated != want:
            raise AssertionError("slot: the paged save restored paged gave other tokens")
        if name == "dense":  # flash_decode reads the dense cache, the plain read the pool
            out["dense_restore"] = check_near_tie(
                eng._plain_generator(), ids, want, r.generated, "paged slot",
                "the paged save restored into a dense batcher vs the uninterrupted run")
    gen = eng._plain_generator()
    sess = tmp / "paged_session.bin"
    for run in ("first", "second"):
        first = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gen.generate(ids, 8, stop_at_eos=False, session_path=sess,
                     on_token=lambda _t: first.setdefault("t", time.perf_counter()))
        out[f"session_ttft_ms_{run}"] = (first["t"] - t0) * 1e3
        out[f"session_reused_{run}"] = gen.session_prefix_reused
    if out["session_reused_second"] != len(ids) - 1:
        raise AssertionError(f"session: the second run reused {out['session_reused_second']}")
    log(f"[paged slot] a slot saved after 20 of {SERVE_NEW} tokens ({out['file_mb']:.1f} MiB in "
        f"{save_ms:.1f} ms), restored into a fresh paged batcher ({out['restore_ms_paged']:.1f} "
        f"ms) and a dense one ({out['restore_ms_dense']:.1f} ms) and resumed: the uninterrupted "
        f"tokens bit for bit; a prompt-cache session: TTFT {out['session_ttft_ms_first']:.1f} ms, "
        f"then {out['session_ttft_ms_second']:.1f} ms with {out['session_reused_second']} "
        f"tokens reused")
    return out


def self_extend_check(eng, vocab, tok) -> dict:
    """(e): `Generator.generate(grp_attn_n=4, grp_attn_w=512)` on a 900-token
    prompt at max_seq 1024, graphed twice and eager once: the same tokens bit
    for bit, and the shifts' device ms (CUDA events around each; (f)'s
    subprocesses load meanwhile)."""
    import torch

    from eagle_tpu_torch.runtime.generate import Generator

    ids = tok.encode(cli_prompt(vocab, 900, seed=70))[:900]
    gen = Generator(eng.params, eng.model_cfg, max_seq=1024, eos_id=tok.eos_id)
    shifts: list = []
    real = gen.self_extend

    def timed(*a):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        res = real(*a)
        ev[1].record()
        ev[1].synchronize()
        shifts.append(ev[0].elapsed_time(ev[1]))
        return res

    gen.self_extend = timed

    def run():
        return gen.generate(ids, 80, stop_at_eos=False, grp_attn_n=4, grp_attn_w=512)

    got = [run(), run()]
    captures = gen.graphs.captures
    got.append(eager_tokens(gen, run))
    if not got[0] == got[1] == got[2] or len(got[0]) != 80:
        raise AssertionError("self-extend: graphed and eager tokens differ")
    if gen.graphs.captures != captures:
        raise AssertionError("self-extend: the second graphed run captured a graph")
    tags = gen.kv.slot_pos[0, :1024]
    out = dict(shift_ms=shifts, n_shifts=len(shifts) // 3, max_tag=int(tags.max()),
               slots=int((tags >= 0).sum()))
    log(f"[paged self-extend] grp_attn_n 4, grp_attn_w 512, a {len(ids)}-token prompt at "
        f"max_seq 1024, 80 tokens: graphed twice == eager, bit for bit; {out['n_shifts']} "
        f"shift(s) per run, device ms {', '.join(f'{x:.3f}' for x in shifts)}; "
        f"{out['slots']} slots tagged, positions up to {out['max_tag']}")
    del gen
    torch.cuda.empty_cache()
    return out


def cli_sessions(target, session_prompt: str, tmp: pathlib.Path, env: dict, cwd) -> dict:
    """The CLI with `--prompt-cache` twice (no draft, greedy, 8 tokens):
    each exits 0 with the same text; the first reuses 0 cached tokens, the
    second the prompt's. Returns their `[perf]` and `[session]` lines."""
    sess = tmp / "cli.session"
    cli = [sys.executable, "-m", "eagle_tpu_torch.tools.cli", "-m", str(target), "-p",
           session_prompt, "-n", "8", "--temp", "0", "--prompt-cache", str(sess)]
    runs = []
    for _ in range(2):
        r = subprocess.run(cli, cwd=cwd, env=env, capture_output=True, text=True, timeout=600)
        lines = [ln for ln in r.stderr.splitlines() if ln.startswith(("[session]", "[perf]"))]
        if r.returncode != 0 or not r.stdout.strip():
            raise AssertionError(f"cli --prompt-cache: exit {r.returncode}: {r.stderr[-2000:]}")
        runs.append((r.stdout, lines))
    if runs[0][0] != runs[1][0] or "reused 0 " not in runs[0][1][-1] \
            or "reused 0 " in runs[1][1][-1]:
        raise AssertionError(f"cli --prompt-cache: {runs}")
    return {"lines": [r[1] for r in runs]}


def paged_http_start(target, draft, tmp: pathlib.Path, session_prompt: str) -> dict:
    """(f) begun: the server with `--paged --kv-pages 64 -np 4` and, on a
    thread, `cli_sessions`, both as subprocesses that load while the phase
    goes on in process. `paged_http` finishes them."""
    import concurrent.futures
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = {k: v for k, v in os.environ.items() if k != "EAGLE_TPU_FUSED_FFN"}
    cwd = pathlib.Path(__file__).resolve().parent
    err_path = tmp / "paged_server.stderr"
    with open(err_path, "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m", "eagle_tpu_torch.server.server", "-m", str(target),
             "--draft", str(draft), "-np", "4", "--paged", "--kv-pages", str(PAGED_PAGES),
             "--page-size", str(PAGE_ROWS), "--host", "127.0.0.1", "--port", str(port)],
            cwd=cwd, env=env, stdout=subprocess.DEVNULL, stderr=err)
    pool = concurrent.futures.ThreadPoolExecutor(1)
    return dict(proc=proc, base=f"http://127.0.0.1:{port}", err_path=err_path, t0=time.time(),
                tmp=tmp, prompt=session_prompt, pool=pool,
                cli=pool.submit(cli_sessions, target, session_prompt, tmp, env, cwd))


def paged_http(ctx: dict) -> dict:
    """(f) finished: once the server answers /health, a streamed /completion
    whose slot 0 is saved while it streams, a /completion, the file restored
    into slot 0 (resumed), then SIGTERM: exit 0 and no traceback; and the CLI
    pair's result."""
    import signal
    import urllib.request

    proc, base, err_path = ctx["proc"], ctx["base"], ctx["err_path"]
    out: dict = {}
    try:
        while True:
            if proc.poll() is not None:
                raise AssertionError(f"paged server exited {proc.returncode}: "
                                     f"{err_path.read_text()[-3000:]}")
            try:
                urllib.request.urlopen(base + "/health", timeout=2)
                break
            except OSError:
                if time.time() - ctx["t0"] > 300:
                    raise
                time.sleep(0.25)
        out["up_s"] = time.time() - ctx["t0"]

        def post(path, body):
            req = urllib.request.Request(base + path, json.dumps(body).encode(),
                                         {"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=300) as r:
                return json.loads(r.read().decode())

        slot_file = str(ctx["tmp"] / "paged_http_slot.bin")
        req = urllib.request.Request(base + "/completion", json.dumps({
            "prompt": ctx["prompt"], "n_predict": 96, "temperature": 0,
            "stream": True}).encode(), {"Content-Type": "application/json"})
        frames = 0
        with urllib.request.urlopen(req, timeout=300) as r:
            for line in r:
                if line.startswith(b"data: "):
                    frames += 1
                    if frames == 8:
                        out["save"] = post("/slots/0?action=save", {"filename": slot_file})
        out["completion"] = post("/completion", {"prompt": ctx["prompt"], "n_predict": 16,
                                                 "temperature": 0})["content"]
        out["restore"] = post("/slots/0?action=restore", {"filename": slot_file})
        if out["save"]["result"]["prompt_len"] < 1 or out["restore"]["result"]["state"] != \
                "generating" or not out["completion"]:
            raise AssertionError(f"paged server: {out}")
        out["cli"] = ctx["cli"].result()
    finally:
        ctx["pool"].shutdown(wait=True)
        if proc.poll() is None:
            proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    stderr = err_path.read_text()
    if proc.returncode != 0 or "Traceback" in stderr:
        raise AssertionError(f"paged server: exit {proc.returncode} after SIGTERM, stderr "
                             f"{stderr[-3000:]}")
    runs = out["cli"]["lines"]
    log(f"[paged cli] --prompt-cache twice: the same text; {' | '.join(runs[0])} then "
        f"{' | '.join(runs[1])}")
    log(f"[paged http] --paged --kv-pages {PAGED_PAGES} -np 4 answered /health {out['up_s']:.1f} "
        f"s after its start (loading beside (e) and the CLI runs); "
        f"slot 0 saved while its stream ran ({frames} chunks, "
        f"{len(out['save']['result']['generated'])} tokens saved), a /completion, the file "
        f"restored into slot 0 and resumed ({out['restore']['result']}); SIGTERM: exit 0")
    return out


def paged_path(report: dict, target, draft, tmp: pathlib.Path) -> dict:
    """Paged and int8 serving on phase 6's files (unfused, K = 5, greedy):
    `Engine(batch=4, max_seq=2048, paged=True, page_size=64, kv_pages=64)`,
    64 pages of 64 rows against 4 x 2,048 addressable slots.
    (a) 1, 2 and 4 streams of phase serve's 301-token prompt, 64 tokens each,
    the prefix cache off: tokens against phase serve's dense batcher (near-tie
    rule), graphed == eager bit for bit, no capture after the warm-up, 129
    qmm_tc per batched verify and CHUNK_QMM per 64-row chunk, no flash_decode
    (the paged read is the plain one), `[paged]` lines; (b) prefix reuse: 4
    requests sharing 256 tokens, each with its own 45, the cache on against
    off (`[paged prefix]`); (c) `int8_checks`; (d) `slot_checks`; (e)
    `self_extend_check`; then the engine freed and `paged_http`. Returns the
    4-stream runs' launches."""
    import gc

    import torch

    from eagle_tpu_torch import _build
    from eagle_tpu_torch.api import Engine, EngineConfig
    from eagle_tpu_torch.gguf import GGUFReader

    os.environ.pop("EAGLE_TPU_FUSED_FFN", None)
    with GGUFReader(target) as reader:
        vocab = reader.metadata["tokenizer.ggml.tokens"]
    t0 = time.time()
    eng = Engine(EngineConfig(model_path=target, draft_path=draft, batch=SERVE_SLOTS,
                              max_seq=2048, paged=True, page_size=PAGE_ROWS,
                              kv_pages=PAGED_PAGES))
    torch.cuda.synchronize()
    out: dict = {"load_s": time.time() - t0}
    tok, b, ce = eng.tokenizer, eng.batcher, eng.engine
    serve = report["serve_path"]["prompt_301"]
    mid = serve["ids"]
    gen = eng._plain_generator()
    log(f"[paged] Engine(batch={SERVE_SLOTS}, max_seq 2048, paged, {PAGED_PAGES} pages of "
        f"{PAGE_ROWS} rows) loaded in {out['load_s']:.1f} s; device memory allocated "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")

    # (a) the pool, the prefix cache off: the cells of phase serve
    parts: dict = {}
    t_part = time.time()
    b.prefix_cache = False
    first = paged_streams(b, mid, 1)  # the warm-up: one graph serves every run's bucket
    out["vs_dense"] = check_near_tie(gen, mid, serve["dense_batched"], first["generated"][0],
                                     "paged", "a paged slot vs phase serve's dense batcher")
    captures, eager = ce.graphs.captures, ce.graphs.eager
    runs: dict = {}
    card = CardSampler()
    with card:
        for n in SERVE_STREAMS:
            if n == SERVE_STREAMS[-1]:
                _build.reset_counts()
            runs[n] = [paged_streams(b, mid, n) for _ in range(REPS)]
            if n == SERVE_STREAMS[-1]:
                launches = dict(_build.launches)
                if any(_build.plain_calls.values()):
                    raise AssertionError(f"paged: plain versions ran: {_build.plain_calls}")
    if (ce.graphs.captures, ce.graphs.eager) != (captures, eager):
        raise AssertionError("paged: a graph was captured or a body ran eagerly after the "
                             "warm-up, across page-table changes")
    graphed = paged_streams(b, mid, 4, PAGED_CHECK_NEW)["generated"]
    if eager_tokens(ce, lambda: paged_streams(b, mid, 4, PAGED_CHECK_NEW)["generated"]) \
            != graphed or graphed[0] != runs[4][0]["generated"][0][:PAGED_CHECK_NEW]:
        raise AssertionError("paged: graphed and eager tokens differ")
    dev = batched_cycle_device(b, mid)
    per = dev["launches"]
    want_per = {"qmm_tc": VERIFY_QMM, "qmm_mma": 6 * ce.K}
    if any(per.get(k, 0) != v for k, v in want_per.items()) or per.get("flash_decode", 0) \
            or dev["plain_calls"]:
        raise AssertionError(f"paged: launches per batched cycle {per}, expected {want_per} "
                             f"and no flash_decode or plain version")
    s = b.submit(mid, max_new_tokens=1, stop_at_eos=False, request_id="chunk")
    b._flush_admissions()
    _build.reset_counts()
    b._advance_prefill()
    chunk = {k: v for k, v in _build.launches.items() if v}
    b.abort("chunk")
    if chunk.get("qmm_tc", 0) != CHUNK_QMM or chunk.get("flash_prefill", 0) or \
            chunk.get("flash_decode", 0):
        raise AssertionError(f"paged: launches per 64-row chunk {chunk}, expected "
                             f"{CHUNK_QMM} qmm_tc and no flash kernel")
    dense = report["serve_path"]
    out["streams"] = {}
    for n, rs in runs.items():
        r = dict(tokens_per_s=spread([x["tokens_per_s"] for x in rs]),
                 step_ms=spread([x["step_ms"] for x in rs]),
                 ttft_ms=[x["ttft_ms"] for x in rs], peak_pages=max(x["peak_pages"] for x in rs))
        r["idle_share"] = 1 - dev["ms"] / r["step_ms"]["median"]
        out["streams"][n] = r
        d = dense["streams"][n]["tokens_per_s"]["median"]
        log(f"[paged] {n} concurrent request(s) of the {len(mid)}-token prompt, {SERVE_NEW} "
            f"tokens each: aggregate tokens/s min / median / max {fmt(r['tokens_per_s'])} "
            f"(dense, phase serve: median {d:.2f}); TTFT ms per request (run 1) "
            f"{', '.join(f'{t:.1f}' for t in r['ttft_ms'][0])}; host ms per step "
            f"{fmt(r['step_ms'])}; idle {100 * r['idle_share']:.1f}%; pool pages in use at most "
            f"{r['peak_pages']} of {PAGED_PAGES}")
    log(f"[paged] batched cycle at B = {SERVE_SLOTS}, every row generating: device "
        f"{dev['ms']:.3f} ms (dense, phase serve: {dense['cycle_device']['ms']:.3f}; CUDA "
        f"events over 8 replays); launches per cycle: "
        + ", ".join(f"{k} {v}" for k, v in sorted(per.items()))
        + f"; per 64-row chunk: " + ", ".join(f"{k} {v}" for k, v in sorted(chunk.items()))
        + f"; graphed == eager ({PAGED_CHECK_NEW} tokens, 4 streams); {ce.graphs.captures} "
          f"graphs, none captured after the warm-up; the card: {card.line()}")
    out.update(cycle_device=dev, chunk_launches=chunk, card_during_runs=card.summary)
    parts["a"] = time.time() - t_part

    # (b) prefix reuse
    t_part = time.time()
    base = tok.encode(cli_prompt(vocab, 300, seed=60))[:PREFIX_TOKENS]
    prompts = [base + tok.encode(cli_prompt(vocab, 60, seed=61 + i), add_bos=False)[
        :SUFFIX_TOKENS] for i in range(4)]
    off = prefix_runs(b, prompts, cache=False)
    on = prefix_runs(b, prompts, cache=True)
    for i, (w, g) in enumerate(zip(off["generated"], on["generated"])):
        check_near_tie(gen, prompts[i], w, g, "paged prefix",
                       f"request {i}, prefix cache on vs off")
    if on["stats"]["prefix_hits"] != 3 or on["stats"]["prefill_tokens_skipped"] != \
            3 * PREFIX_TOKENS:
        raise AssertionError(f"paged prefix: {on['stats']}")
    out["prefix"] = dict(on=on, off=off)
    log(f"[paged prefix] 4 requests of {len(prompts[0])} tokens sharing {PREFIX_TOKENS}: "
        f"{on['stats']}; TTFT ms per request, the cache on "
        f"{', '.join(f'{t:.1f}' for t in on['ttft_ms'])} against off "
        f"{', '.join(f'{t:.1f}' for t in off['ttft_ms'])}")
    b.prefix_cache = False
    parts["b"] = time.time() - t_part

    t_part = time.time()
    out["int8"] = int8_checks(eng, gen, mid, runs[4][0]["generated"][0])
    parts["c"] = time.time() - t_part
    t_part = time.time()
    out["slots"] = slot_checks(eng, mid, tmp)
    parts["d"] = time.time() - t_part
    # (f) begins: its subprocesses load beside (e)
    http = paged_http_start(target, draft, tmp, tok.decode(mid[1:], skip_special=True))
    t_part = time.time()
    out["self_extend"] = self_extend_check(eng, vocab, tok)
    parts["e"] = time.time() - t_part
    del eng, b, ce, gen
    gc.collect()
    torch.cuda.empty_cache()
    t_part = time.time()
    out["http"] = paged_http(http)
    parts["f"] = time.time() - t_part
    out["part_seconds"] = parts
    log("[paged] seconds per part: " + ", ".join(f"({k}) {v:.1f}" for k, v in parts.items()))
    report["paged_path"] = out
    return launches


# --------------------------------------------------------------------------
# phase 7: the kernel benchmark, and qmm_i4 at the 7B projections


I4_ROWS = (1, 2, 3, 6, 8, 37, 512)  # qmm_i4's SIMT (1), small-row (2-8) and wgmma rows


CONSTRAINED_WORDS = 100  # the phase's prompt, in vocabulary words
STATEFUL_NEW = 32  # new tokens of each stateful run
#: new tokens of each constrained run: the grammar's stack deepens with every
#: repetition of `+` (the reference's automaton, copied), so the letters'
#: mask walk grows with the text
CONSTRAINED_NEW = {"letters": 24, "json": 48}
STATEFUL_CONFIGS = {  # SamplerConfig fields of each stateful cell
    "penalties": dict(greedy=True, penalty_repeat=1.3, penalty_freq=0.2, penalty_present=0.2),
    "dry": dict(greedy=True, dry_multiplier=0.8, dry_allowed_length=2),
    "mirostat_v1": dict(mirostat=1, mirostat_tau=5.0, temperature=1.0),
    "mirostat_v2": dict(mirostat=2, mirostat_tau=5.0, temperature=1.0),
}
CLI_PENALTY = dict(temperature=0.0, greedy=True, penalty_repeat=1.3)  # --temp 0 --repeat-penalty 1.3
#: letters a-h and the space: 490 of the 32,000 pieces legal at a time. The
#: walk over the vocabulary's trie grows with the legal pieces: at [a-z ]+
#: (31,768 legal) it visits nearly the whole trie for every token
LETTERS_GBNF = "root ::= [a-h ]+"
CONSTRAINED_SCHEMA = {"type": "object", "properties": {"a": {"type": "boolean"},
                                                       "b": {"enum": ["x", "y"]}},
                      "required": ["a", "b"]}
CONSTRAINED_TOOLS = [{"type": "function", "function": {
    "name": "add", "description": "add two numbers",
    "parameters": {"type": "object", "properties": {"a": {"type": "boolean"}},
                   "required": ["a"]}}}]
PROPOSAL_LAUNCHES = {"qmm_mma": VERIFY_QMM, "qmm_gemv": 5 * 6}  # the verify; K = 5 draft steps


def timed_mask(grammar) -> dict:
    """Wrap `grammar.token_mask` to add up its host time and its calls."""
    real, acc = grammar.token_mask, {"calls": 0, "s": 0.0}

    def token_mask(trie):
        t0 = time.perf_counter()
        try:
            return real(trie)
        finally:
            acc["s"] += time.perf_counter() - t0
            acc["calls"] += 1

    grammar.token_mask = token_mask
    return acc


def constrained_near_tie(gen, ids, want: list, got: list, gbnf: str, pieces, trie, eos: int,
                         what: str) -> dict | None:
    """Where two constrained greedy streams first differ, the top-2 margin
    of the target's logits among the tokens the grammar allows there (full
    prefill of the common prefix) must be within 1e-2 of the logit range:
    a bf16 near-tie, not a divergence."""
    import numpy as np
    import torch

    from eagle_tpu_torch.runtime.grammar import Grammar

    i = next((j for j, (a, b) in enumerate(zip(want, got)) if a != b), None)
    if i is None:
        if len(want) != len(got):
            raise AssertionError(f"{what}: {len(got)} tokens against {len(want)}")
        log(f"[constrained] {what}: tokens identical ({len(got)} tokens)")
        return None
    g = Grammar(gbnf)
    for t in want[:i]:
        g.accept_token(t, pieces[t])
    mask = g.token_mask(trie)
    mask[eos] = bool(g.can_end)
    seq = list(ids) + want[:i]
    t = 1024 if len(seq) > 512 else 512
    padded = np.zeros((1, t), np.int32)
    padded[0, : len(seq)] = seq
    lg, _, _ = gen._prefill(torch.from_numpy(padded).cuda(),
                            torch.tensor([len(seq)], dtype=torch.int32, device="cuda"), t)
    lg = lg[0].float().cpu().numpy()
    legal = np.sort(lg[mask])[::-1]
    margin = float(legal[0] - legal[1]) if len(legal) > 1 else float("inf")
    rng = float(lg.max() - lg.min())
    log(f"[constrained] {what}: tokens differ first at step {i}: top-2 margin among the legal "
        f"tokens {margin:.4e}, logit range {rng:.4e}")
    if margin > 1e-2 * rng:
        raise AssertionError(f"{what}: tokens diverge beyond a bf16 near-tie")
    return dict(step=i, margin=margin, logit_range=rng)


def stateful_cells(gen, ids: list, greedy_ms: float, report: dict) -> dict:
    """Each stateful sampler through the graphed `Generator`: eager once,
    graphed twice from seed 0 (the first run captures), the same tokens bit
    for bit, no capture and no eager body on the second run, 129 qmm_gemv
    per decoded token; device ms per token over 16 replays against the
    greedy step's (this phase) and phase cli's sampled step."""
    import torch

    from eagle_tpu_torch import _build
    from eagle_tpu_torch.runtime.sampling import SamplerConfig

    cli_sampled = report["cli_path"]["sampler_share_ms"]["plain"]["sampled_ms"]
    out = {}
    for name, kw in STATEFUL_CONFIGS.items():
        scfg = SamplerConfig(**kw)

        def run():
            return gen.generate(ids, STATEFUL_NEW, sampler=scfg, seed=0, stop_at_eos=False)

        want = eager_tokens(gen, run)
        if run() != want:  # the capture run
            raise AssertionError(f"stateful {name}: graphed tokens differ from eager tokens")
        captures, eager = gen.graphs.captures, gen.graphs.eager
        _build.reset_counts()
        t0 = time.perf_counter()
        again = run()
        wall = time.perf_counter() - t0
        if again != want or (gen.graphs.captures, gen.graphs.eager) != (captures, eager):
            raise AssertionError(f"stateful {name}: a second graphed run differs, captured a "
                                 "graph or ran a body eagerly")
        if _build.launches["qmm_gemv"] != DECODE_QMM * (STATEFUL_NEW - 1) or any(
                _build.plain_calls.values()):
            raise AssertionError(f"stateful {name}: launches {dict(_build.launches)}")
        pos = len(ids) + STATEFUL_NEW - 1
        lim = gen.kv_read_bucket(pos + 16)
        last = torch.tensor([want[-1]], dtype=torch.int32, device="cuda")
        gen._decode_chunk(last, pos, scfg, 16, kv_limit=lim)  # the bucket's graph
        eager = gen.graphs.eager
        dev = timed_events(lambda: gen._decode_chunk(last, pos, scfg, 16, kv_limit=lim), 16)
        if gen.graphs.eager != eager:
            raise AssertionError(f"stateful {name}: a step ran eagerly while timed")
        out[name] = dict(config=kw, distinct_tokens=len(set(want)), device=dev,
                         share_ms=dev["ms"] - greedy_ms, wall_s=wall)
        log(f"[constrained stateful] {name}: graphed == eager bit for bit, no recapture; "
            f"{len(set(want))} distinct tokens of {len(want)}; device {dev['ms']:.3f} ms per "
            f"token (greedy {greedy_ms:.3f}: +{dev['ms'] - greedy_ms:.3f}; phase cli's sampled "
            f"step {cli_sampled:.3f}); 129 qmm_gemv per token")
    return out


def chat_penalty(eng, gen, texts: list) -> dict:
    """Two chat turns with a repeat penalty (greedy): graphed once to
    capture, again with no capture, and eager: the same tokens bit for bit;
    the timed session's decode tokens/s."""
    import torch

    from eagle_tpu_torch.runtime.sampling import SamplerConfig

    scfg = SamplerConfig(greedy=True, penalty_repeat=1.3)
    marks: dict = {}

    def session():
        gen.kv.rollback(torch.zeros((1,), dtype=torch.int32, device="cuda"))
        s = eng.chat_session(template="vicuna")
        outs, decode = [], []
        for t in texts:
            n = [0]
            first = []

            def cb(_tok, n=n, first=first):
                if not first:
                    torch.cuda.synchronize()
                    first.append(time.perf_counter())
                n[0] += 1

            s.ask(t, max_new_tokens=STATEFUL_NEW, sampler=scfg, on_token=cb)
            torch.cuda.synchronize()
            decode.append((n[0] - 1) / max(time.perf_counter() - first[0], 1e-9))
            outs.append(list(s.last_out))
        marks["decode_tps"] = decode
        return outs

    want = eager_tokens(gen, session)
    if session() != want:
        raise AssertionError("chat penalty: graphed tokens differ from eager tokens")
    captures = gen.graphs.captures
    if session() != want or gen.graphs.captures != captures:
        raise AssertionError("chat penalty: a second session differs or captured a graph")
    log(f"[constrained chat] 2 turns with repeat penalty 1.3: graphed == eager bit for bit, "
        f"no recapture; decode tokens/s per turn {', '.join(f'{x:.1f}' for x in marks['decode_tps'])}")
    return dict(turn_tokens=[len(t) for t in want], decode_tps=marks["decode_tps"])


def constrained_cells(eng, gen, ids: list, tok, pieces, trie) -> tuple[dict, dict]:
    """The letter grammar and the JSON schema, each through the plain
    constrained generator (graphed twice, eager once for the letters) and
    the chain (graphed twice): the grammar accepts every text, the schema's
    parses where it closed, the chain's tokens equal the plain ones up to
    the near-tie rule, no capture on a second run; launches per proposal
    asserted; host ms per token of the mask walk, wall ms per token, device
    ms per constrained step and per proposal (CUDA events over replays).
    Returns (results, the chain's launches of the timed letters run)."""
    import torch

    from eagle_tpu_torch import _build
    from eagle_tpu_torch.runtime.grammar import Grammar
    from eagle_tpu_torch.runtime.json_schema import json_schema_to_gbnf

    ce, eos = eng.engine, tok.eos_id
    out: dict = {}
    chain_launches: dict = {}
    for name, gbnf in (("letters", LETTERS_GBNF),
                       ("json", json_schema_to_gbnf(CONSTRAINED_SCHEMA))):
        res: dict = {}
        n_new = CONSTRAINED_NEW[name]

        def plain_run():
            g = Grammar(gbnf)
            acc = timed_mask(g)
            t0 = time.perf_counter()
            toks = gen.generate_constrained(ids, g, tok, max_new_tokens=n_new)
            return toks, acc, time.perf_counter() - t0

        def chain_run():
            g = Grammar(gbnf)
            acc = timed_mask(g)
            t0 = time.perf_counter()
            toks, stats = ce.generate_constrained(ids, g, tok, max_new_tokens=n_new)
            return toks, stats, acc, time.perf_counter() - t0

        want = plain_run()[0]  # the capture run
        captures = gen.graphs.captures
        _build.reset_counts()
        toks, acc, wall = plain_run()
        steps = len(toks) - (toks[-1] == eos)
        if toks != want or gen.graphs.captures != captures:
            raise AssertionError(f"constrained {name}: a second plain run differs or captured")
        if _build.launches["qmm_gemv"] != DECODE_QMM * steps:
            raise AssertionError(f"constrained {name}: {_build.launches['qmm_gemv']} qmm_gemv "
                                 f"for {steps} steps")
        if name == "letters" and eager_tokens(gen, lambda: plain_run()[0]) != want:
            raise AssertionError(f"constrained {name}: eager tokens differ from graphed")
        text = "".join(pieces[t] for t in want if t != eos)
        closed = want[-1] == eos
        if not Grammar(gbnf).accepts_text(text, partial=not closed):
            raise AssertionError(f"constrained {name}: the grammar refuses {text[:200]!r}")
        if name == "json" and closed:
            obj = json.loads(text)
            if not isinstance(obj["a"], bool) or obj["b"] not in ("x", "y"):
                raise AssertionError(f"constrained json: {obj}")
        pos = len(ids) + len(want)

        def steps():
            return [gen._constrained_step(want[-1], pos + i) for i in range(16)]

        steps()  # the graphs of every read bucket the 16 steps take
        eager = gen.graphs.eager
        dev = timed_events(steps, 16)
        if gen.graphs.eager != eager:
            raise AssertionError(f"constrained {name}: a step ran eagerly while timed")
        res["plain"] = dict(tokens=len(want), closed=closed, text=text[:400],
                            mask_host_ms_per_token=acc["s"] * 1e3 / len(want),
                            mask_calls=acc["calls"], wall_ms_per_token=wall * 1e3 / len(want),
                            device_ms_per_step=dev["ms"])
        got = chain_run()[0]  # the capture run
        captures = ce.graphs.captures
        _build.reset_counts()
        got2, stats, cacc, cwall = chain_run()
        launches = dict(_build.launches)
        if got2 != got or ce.graphs.captures != captures:
            raise AssertionError(f"constrained {name}: a second chain run differs or captured")
        per = {k: launches[k] / stats["n_cycles"] for k in PROPOSAL_LAUNCHES}
        if per != PROPOSAL_LAUNCHES or any(_build.plain_calls.values()):
            raise AssertionError(f"constrained {name}: launches per proposal {per}")
        if name == "letters":
            chain_launches = launches
        tie = constrained_near_tie(gen, ids, want, got, gbnf, pieces, trie, eos,
                                   f"{name}: chain vs plain")
        st, m = ce.state, int(ce.state.n_past[0])
        lim = ce.kv_read_bucket(m + ce.K + 2)
        ce._propose(lim, 256)  # the bucket's graph
        eager = ce.graphs.eager
        pdev = timed_events(lambda: [ce._propose(lim, 256) for _ in range(8)], 8)
        if ce.graphs.eager != eager:
            raise AssertionError(f"constrained {name}: a proposal ran eagerly while timed")
        res["chain"] = dict(tokens=len(got), stats=stats, near_tie=tie,
                            mask_host_ms_per_token=cacc["s"] * 1e3 / len(got),
                            mask_calls=cacc["calls"], wall_ms_per_token=cwall * 1e3 / len(got),
                            device_ms_per_proposal=pdev["ms"], launches_per_proposal=per)
        p, c = res["plain"], res["chain"]
        log(f"[constrained] {name}: plain {p['tokens']} tokens ({'closed' if closed else 'open'}, "
            f"accepted by the grammar{', json.loads' if name == 'json' and closed else ''}): "
            f"wall {p['wall_ms_per_token']:.2f} ms per token, the mask walk "
            f"{p['mask_host_ms_per_token']:.2f} ms per token on the host, device "
            f"{p['device_ms_per_step']:.3f} ms per step; chain {c['tokens']} tokens, "
            f"mean_accept_len {stats['mean_accept_len']:.3f} over {stats['n_cycles']} "
            f"proposals: wall {c['wall_ms_per_token']:.2f} ms per token, mask "
            f"{c['mask_host_ms_per_token']:.2f} ms per token ({cacc['calls']} walks), device "
            f"{c['device_ms_per_proposal']:.3f} ms per proposal; launches per proposal {per}; "
            f"text {text[:60]!r}")
        out[name] = res
    return out, chain_launches


def constrained_subprocesses(target, draft, prompt: str, want: dict, tmp: pathlib.Path) -> dict:
    """The CLI with `--draft --grammar` and with `--repeat-penalty 1.3 --temp
    0`, and the server (`-np 1`), as subprocesses started together: each
    CLI's text must equal the in-process run's; the server must answer a
    `json_schema` completion whose content parses with the schema's keys
    and a `tools` request with `tool_choice: "required"` with a
    `tool_calls` message, then end with exit 0 on SIGTERM."""
    import signal
    import socket
    import urllib.request

    env = {k: v for k, v in os.environ.items() if k != "EAGLE_TPU_FUSED_FFN"}
    cwd = pathlib.Path(__file__).resolve().parent
    base = [sys.executable, "-m", "eagle_tpu_torch.tools.cli", "-m", str(target), "-p", prompt]
    clis = {"grammar": base + ["-n", str(CONSTRAINED_NEW["letters"]), "--draft", str(draft),
                               "--grammar", LETTERS_GBNF],
            "repeat_penalty": base + ["-n", str(STATEFUL_NEW), "--repeat-penalty", "1.3",
                                      "--temp", "0"]}
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    url = f"http://127.0.0.1:{port}"
    err_path = tmp / "constrained_server.stderr"
    t0 = time.time()
    procs = {k: subprocess.Popen(v, cwd=cwd, env=env, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True) for k, v in clis.items()}
    with open(err_path, "w") as err:
        server = subprocess.Popen(
            [sys.executable, "-m", "eagle_tpu_torch.server.server", "-m", str(target), "--draft",
             str(draft), "-np", "1", "--host", "127.0.0.1", "--port", str(port)],
            cwd=cwd, env=env, stdout=subprocess.DEVNULL, stderr=err)
    out: dict = {}
    try:
        while True:
            if server.poll() is not None:
                raise AssertionError(f"server exited {server.returncode} before it answered: "
                                     f"{err_path.read_text()[-3000:]}")
            try:
                urllib.request.urlopen(url + "/health", timeout=2)
                break
            except OSError:
                if time.time() - t0 > 300:
                    raise
                time.sleep(0.25)
        out["server_up_s"] = time.time() - t0

        def post(path, body):
            req = urllib.request.Request(url + path, json.dumps(body).encode(),
                                         {"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=600) as r:
                return json.loads(r.read())

        t1 = time.time()
        res = post("/completion", {"prompt": prompt, "n_predict": 256,
                                   "json_schema": CONSTRAINED_SCHEMA, "temperature": 0})
        out["json_s"] = time.time() - t1
        obj = json.loads(res["content"])
        if not isinstance(obj["a"], bool) or obj["b"] not in ("x", "y"):
            raise AssertionError(f"server json_schema: {res['content'][:300]!r}")
        t1 = time.time()
        res = post("/v1/chat/completions", {
            "messages": [{"role": "user", "content": "add 1 and 2"}], "max_tokens": 256,
            "temperature": 0, "tools": CONSTRAINED_TOOLS, "tool_choice": "required"})
        out["tools_s"] = time.time() - t1
        choice = res["choices"][0]
        call = (choice["message"].get("tool_calls") or [{}])[0].get("function", {})
        if choice["finish_reason"] != "tool_calls" or call.get("name") != "add" or \
                not isinstance(json.loads(call["arguments"])["a"], bool):
            raise AssertionError(f"server tools: {json.dumps(choice)[:600]}")
        out["tool_call"] = call
    finally:
        if server.poll() is None:
            server.send_signal(signal.SIGTERM)
        try:
            server.wait(timeout=60)
        except subprocess.TimeoutExpired:
            server.kill()
            server.wait()
        done = {k: (p, *p.communicate(timeout=600)) for k, p in procs.items()}
    stderr = err_path.read_text()
    if server.returncode != 0 or "Traceback" in stderr:
        raise AssertionError(f"server: exit {server.returncode} after SIGTERM, stderr "
                             f"{stderr[-3000:]}")
    for name, (p, stdout, stderr_c) in done.items():
        if p.returncode != 0 or stdout.rstrip("\n") != want[name]:
            raise AssertionError(f"cli {name}: exit {p.returncode}, text {stdout[-300:]!r} "
                                 f"against the in-process {want[name][-300:]!r}, stderr "
                                 f"{stderr_c[-2000:]}")
    out["seconds"] = time.time() - t0
    log(f"[constrained cli] --draft --grammar and --repeat-penalty 1.3 --temp 0: exit 0, each "
        f"text == the in-process run's; [constrained http] the server answered /health "
        f"{out['server_up_s']:.1f} s after its start: a json_schema /completion in "
        f"{out['json_s']:.2f} s (parses), a tools request (tool_choice required) in "
        f"{out['tools_s']:.2f} s: tool_calls {call['name']}({call['arguments']}); SIGTERM exit 0; "
        f"{out['seconds']:.1f} s in all")
    return out


def constrained_path(report: dict, target, draft, tmp: pathlib.Path) -> dict:
    """Stateful samplers and grammar-constrained decoding on phase 6's files
    (unfused, K = 5): one `Engine` (the chain, greedy, max_seq 2048) and its
    plain `Generator`; `stateful_cells`, `chat_penalty`,
    `constrained_cells`; then the engine freed and
    `constrained_subprocesses`. Returns the chain's launches of the timed
    letter-grammar run."""
    import gc

    import torch

    from eagle_tpu_torch.api import Engine, EngineConfig
    from eagle_tpu_torch.gguf import GGUFReader
    from eagle_tpu_torch.runtime.grammar import Grammar, TokenTrie
    from eagle_tpu_torch.runtime.sampling import SamplerConfig

    os.environ.pop("EAGLE_TPU_FUSED_FFN", None)
    with GGUFReader(target) as reader:
        vocab = reader.metadata["tokenizer.ggml.tokens"]
    prompt = cli_prompt(vocab, n_words=CONSTRAINED_WORDS, seed=11)
    t0 = time.time()
    eng = Engine(EngineConfig(model_path=target, draft_path=draft, max_seq=2048))
    torch.cuda.synchronize()
    out: dict = {"load_s": time.time() - t0}
    tok = eng.tokenizer
    ids = tok.encode(prompt)
    gen = eng._plain_generator()
    pieces = [tok.piece(i) for i in range(len(vocab))]
    trie = TokenTrie(pieces)
    brace = tok.piece(vocab.index("<0x7B>"))
    log(f"[constrained] Engine loaded in {out['load_s']:.1f} s; the prompt is {len(ids)} "
        f"tokens; the byte token <0x7B> is the piece {brace!r} (JSON is spelled with byte "
        f"tokens)")
    if brace != "{":
        raise AssertionError("the byte tokens do not come through as pieces")
    greedy_ms = decode_device_ms(gen, ids)
    out["greedy_step_ms"] = greedy_ms
    out["stateful"] = stateful_cells(gen, ids, greedy_ms, report)
    out["chat"] = chat_penalty(eng, gen, chat_texts(vocab)[:2])
    out["constrained"], launches = constrained_cells(eng, gen, ids, tok, pieces, trie)
    # the CLI's runs in process, for the subprocesses' texts
    eos = tok.eos_id
    g_toks, _ = eng.engine.generate_constrained(ids, Grammar(LETTERS_GBNF), tok,
                                                max_new_tokens=CONSTRAINED_NEW["letters"])
    p_toks = gen.generate(ids, STATEFUL_NEW, sampler=SamplerConfig(**CLI_PENALTY))
    want = {k: tok.decode([t for t in v if t != eos], skip_special=True)
            for k, v in (("grammar", g_toks), ("repeat_penalty", p_toks))}
    del eng, gen
    gc.collect()
    torch.cuda.empty_cache()
    out["subprocesses"] = constrained_subprocesses(target, draft, prompt, want, tmp)
    report["constrained_path"] = out
    return launches


# --------------------------------------------------------------------------
# phase runtime: model-free speculation, YaRN and fill-in-the-middle


RUNTIME_WORDS = 100  # the phase's distinct words, said three times: lookup drafts from them
RUNTIME_NEW = 64  # new tokens of each lookahead / lookup run
LOOKAHEAD = (8, 4, 8)  # (W, N, G): the reference's defaults, T = 48 rows a step
LOOKAHEAD_ROWS = 1 + 8 * 3 + 7 + 2 * 8
LOOKUP_K = 8  # 9 verify rows
#: a step's launches: 4 products per layer and lm_head at 48 (9) rows, and
#: one flash_decode per layer over the whole cache (the window included)
STEP_LAUNCHES = {"qmm_tc": 129, "flash_decode": 32}
YARN_PROMPT = 5000  # tokens, bucket 8,192: positions past the original 4,096
YARN_SEQ = 8192
YARN_NEW = 64
YARN_SHIFT = (64, 1024)  # the context shift: keep, discard
#: NousResearch/Yarn-Llama-2-7b-64k's config.json rope_scaling
YARN_MD = {"llama.rope.scaling.type": "yarn", "llama.rope.scaling.factor": 16.0,
           "llama.rope.scaling.original_context_length": 4096}
#: CodeLlama-7b's vocabulary: 32,016 pieces, its four FIM control pieces at
#: 32007-32010 and the GGUF keys naming them (convert_hf_to_gguf's CodeLlama)
FIM_PIECES = {"prefix": (32007, "▁<PRE>"), "suffix": (32008, "▁<SUF>"),
              "middle": (32009, "▁<MID>"), "eot": (32010, "▁<EOT>")}
INFILL_NEW = 32
INFILL_TEXT = ("def fib(n):\n    a, b = 0, 1\n    for _ in range(n):\n        ",
               "\n    return a\n\nprint(fib(10))\n")


def model_free_cell(tag: str, eng, ids: list, greedy: list, gen, make_replay) -> dict:
    """`eng` (a LookaheadEngine or LookupEngine on the card) on `ids`, 64 new
    tokens, stop at EOS off: eager (graphs off) and graphed, 2 timed runs
    each after one graphed run that captures; graphed == eager bit for bit,
    the tokens == greedy's up to the near-tie rule, the launches of a step
    (`STEP_LAUNCHES`, a replay counting as an eager step) and of a whole
    run (the prompt's forward one more step); device ms per step by CUDA
    events over 8 replays of the last step (`make_replay()` gives the
    replay) and the idle share of the median graphed run. A lookup
    engine's n-gram cache starts empty in each run."""
    from eagle_tpu_torch import _build
    from eagle_tpu_torch.runtime.lookup import NgramCache

    def run(on_token):
        if getattr(eng, "ngram", None) is not None:  # lookup's cache learns across calls
            eng.ngram = NgramCache()
        return eng.generate(ids, max_new_tokens=RUNTIME_NEW, stop_at_eos=False,
                            on_token=on_token)

    steps_key = "n_steps" if hasattr(eng, "lay") else "n_cycles"  # lookahead / lookup
    eager = [timed_run(lambda cb: eager_tokens(eng, lambda: run(cb))) for _ in range(REPS)]
    want = eager[0][0]
    if any(r[0] != want for r in eager):
        raise AssertionError(f"{tag}: two eager runs differ")
    first = run(None)  # the capture
    if first != want:
        raise AssertionError(f"{tag}: graphed tokens or stats differ from eager")
    captures = eng.graphs.captures
    for key, g in eng.graphs._graphs.items():
        counts = {k: v for k, v in g.counts.items() if v}
        if counts != STEP_LAUNCHES:
            raise AssertionError(f"{tag}: a step's launches {counts}, not {STEP_LAUNCHES}")
    graphed = []
    for _ in range(REPS):
        eager_before = eng.graphs.eager
        _build.reset_counts()
        graphed.append(timed_run(run))
        launches = {k: v for k, v in _build.launches.items() if v}
        n_steps = graphed[-1][0][1][steps_key]
        if graphed[-1][0] != want or eng.graphs.eager != eager_before or \
                eng.graphs.captures != captures:
            raise AssertionError(f"{tag}: a graphed run differs, captured or ran a body eagerly")
        expect = {k: v * (n_steps + 1) for k, v in STEP_LAUNCHES.items()}  # + the prompt
        if launches != expect or any(_build.plain_calls.values()):
            raise AssertionError(f"{tag}: launches {launches}, not {expect}")
    tokens, stats = want
    near = check_near_tie(gen, ids, greedy, tokens[:len(greedy)], "runtime", f"{tag} vs greedy")
    eager_before = eng.graphs.eager
    replay = make_replay()
    dev = timed_events(lambda: [replay() for _ in range(8)], 8)
    if eng.graphs.eager != eager_before:
        raise AssertionError(f"{tag}: a step ran eagerly while it was timed")
    tps = [(RUNTIME_NEW - 1) / r[2] for r in graphed]
    med = sorted(graphed, key=lambda r: r[2])[REPS // 2]
    n_steps = stats[steps_key]
    idle = 1 - dev["ms"] * n_steps / (med[2] * 1e3)
    out = dict(stats=stats, launches_per_step=STEP_LAUNCHES, launches_per_run=launches,
               tokens_per_s=spread(tps), ttft_ms=spread([r[1] * 1e3 for r in graphed]),
               eager_tokens_per_s=spread([(RUNTIME_NEW - 1) / r[2] for r in eager]),
               device_ms_per_step=dev["ms"], idle_share=idle, near_tie=near)
    shown = ", ".join(f"{k} {v:.3f}" if isinstance(v, float) else f"{k} {v}"
                      for k, v in stats.items())
    log(f"[runtime {tag}] graphed == eager bit for bit; {n_steps} steps for {RUNTIME_NEW} "
        f"tokens ({shown}); "
        f"t/s graphed {fmt(out['tokens_per_s'])}, eager {fmt(out['eager_tokens_per_s'])}; TTFT "
        f"{fmt(out['ttft_ms'], 1)} ms; device {dev['ms']:.3f} ms per step (CUDA events over 8 "
        f"replays), idle {100 * idle:.1f} % of the median graphed run; per step "
        f"{STEP_LAUNCHES['qmm_tc']} qmm_tc and {STEP_LAUNCHES['flash_decode']} flash_decode")
    return out


def runtime_kernels(params, gen) -> dict:
    """The slice's new shapes on the served Q4_0 weights and the attention
    it reads: qmm at 9 rows (a lookup verify) and 48 rows (a lookahead
    step), both on `qmm_tc` (`qmm_sum`: kernel, plain, bound and library ms
    per call and per step); flash_decode at T = 48 under a lookahead step's
    mask over a 2,048-slot cache (365 committed slots with holes, the
    window in the last 48), against its plain version (rel err <= 1e-2)."""
    import torch
    import torch.nn.functional as F

    from eagle_tpu_torch.ops import flash_attention as fa
    from eagle_tpu_torch.runtime.lookahead import _Layout

    out: dict = {"qmm": []}
    specs = target_qmm_specs(params)
    for what, rows in (("lookup verify", LOOKUP_K + 1), ("lookahead step", LOOKAHEAD_ROWS)):
        out[f"qmm per {what}"] = qmm_sum("runtime kernel", what, rows, specs, "qmm_tc", gen,
                                         out["qmm"])
    lay = _Layout(*LOOKAHEAD)
    b, t, h, d, s = 1, lay.T, 32, 128, 2048
    k_cache = torch.randn((2, b, h, s + 1, d), generator=gen, device="cuda").to(torch.bfloat16)
    v_cache = torch.randn((2, b, h, s + 1, d), generator=gen, device="cuda").to(torch.bfloat16)
    base, n_past = s - t, 365
    tags = torch.full((b, s), -1, dtype=torch.int32, device="cuda")
    tags[:, :n_past] = torch.arange(n_past, dtype=torch.int32, device="cuda")
    tags[:, 200:203] = -1  # rolled-back verify rows
    pos = n_past + torch.from_numpy(lay.pos_off).cuda()
    ok = torch.ones(t, dtype=torch.bool, device="cuda")
    ok[torch.from_numpy(lay.gram_rows[3:].reshape(-1)).long().cuda()] = False  # 3 live grams
    tags[:, base:] = torch.where(ok, pos, -1)
    committed = (tags >= 0) & (torch.arange(s, device="cuda") < base)
    mask = committed[:, None, :] & (tags[:, None, :] <= pos[None, :, None])
    mask[:, :, base:] = torch.from_numpy(lay.visible).cuda() & ok[None, :]
    q = torch.randn((b, t, h, d), generator=gen, device="cuda")
    got = fa.flash_attention_cached(q, k_cache, v_cache, mask, 1, s_limit=s)
    abs_err, rel = rel_err(got, fa.flash_attention_cached_plain(q, k_cache, v_cache, mask, 1,
                                                                 s_limit=s))
    if rel > ATTN_TOL or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"flash_decode T={t} lookahead mask: rel err {rel:.3e}")
    ms = device_ms(lambda i: fa.flash_attention_cached(q, k_cache, v_cache, mask, i % 2,
                                                       s_limit=s), 50)
    plain = device_ms(lambda i: fa.flash_attention_cached_plain(q, k_cache, v_cache, mask,
                                                               i % 2, s_limit=s), 10)
    qb = q.transpose(1, 2).to(torch.bfloat16)
    kl, vl = k_cache[1, :, :, :s], v_cache[1, :, :, :s]
    lib = device_ms(lambda i: F.scaled_dot_product_attention(qb, kl, vl,
                                                             attn_mask=mask[:, None]), 50)
    seen = int(mask.any(dim=1).sum())  # slots some row sees: the bytes that must move
    b_ms, b_by = bound_ms(2 * b * h * seen * d * 2 + nbytes(q, mask) + q.numel() * 4,
                          4.0 * int(mask.sum()) * h * d)
    out["flash_decode"] = dict(t=t, s=s, mask="lookahead", ms=ms, plain_ms=plain,
                               bound_ms=b_ms, bound_by=b_by, library_ms=lib,
                               max_abs_err=abs_err, rel_err=rel, slots_seen=seen)
    log(f"[runtime kernel] flash_decode T={t} S={s} H={h} D={d} lookahead mask ({seen} slots "
        f"seen)  kernel {ms:.4f} ms  plain {plain:.4f} ms  bound {b_ms * 1e3:.2f} us ({b_by})  "
        f"library {lib:.4f} ms  rel err {rel:.2e}")
    del k_cache, v_cache
    torch.cuda.empty_cache()
    return out


def lookahead_lookup(report: dict, target, tmp: pathlib.Path) -> tuple[dict, dict]:
    """(a) On phase 6's Q4_0 target (unfused, max_seq 2,048), a ~300-token
    prompt of 100 words said three times: `Engine(lookahead=(8, 4, 8))`
    (greedy) and a `LookupEngine(n_draft=8)` over its params, each through
    `model_free_cell`; an oracle lookup run (its n-gram cache fed the
    prompt and the greedy continuation, prompt lookup off: it drafts the
    greedy tokens), graphed; `runtime_kernels`. Returns (the cell results,
    the launches of one graphed lookahead run and one lookup run)."""
    import gc

    import torch

    from eagle_tpu_torch import _build
    from eagle_tpu_torch.api import Engine, EngineConfig
    from eagle_tpu_torch.gguf import GGUFReader
    from eagle_tpu_torch.runtime import lookup as lookup_mod
    from eagle_tpu_torch.runtime.lookup import LookupEngine

    os.environ.pop("EAGLE_TPU_FUSED_FFN", None)
    with GGUFReader(target) as reader:
        vocab = reader.metadata["tokenizer.ggml.tokens"]
    words = cli_prompt(vocab, n_words=RUNTIME_WORDS, seed=13)
    t0 = time.time()
    eng = Engine(EngineConfig(model_path=target, max_seq=2048, lookahead=LOOKAHEAD))
    torch.cuda.synchronize()
    ids = eng.tokenizer.encode(" ".join([words] * 3))
    gen = eng._plain_generator()
    greedy = gen.generate(ids, max_new_tokens=RUNTIME_NEW, stop_at_eos=False)
    out: dict = {"load_s": time.time() - t0, "prompt_tokens": len(ids)}
    log(f"[runtime] phase 6's target loaded with lookahead {LOOKAHEAD} in {out['load_s']:.1f} s; "
        f"the prompt is {len(ids)} tokens ({RUNTIME_WORDS} words, three times)")
    out["greedy_step_ms"] = decode_device_ms(gen, ids)
    la = eng.engine
    out["lookahead"] = model_free_cell("lookahead", la, ids, greedy, gen, lambda: la._replay)
    lu = LookupEngine(eng.params, eng.model_cfg, n_draft=LOOKUP_K, max_seq=2048,
                      eos_id=eng.tokenizer.eos_id)

    def lookup_replay():  # the last verify again, at its read bucket
        lim = lu.kv_read_bucket(int(lu._in[-1]) + LOOKUP_K + 1)
        return lambda: lu._replay(lim)

    out["lookup"] = model_free_cell("lookup", lu, ids, greedy, gen, lookup_replay)
    launches = {}
    for name, e in (("lookahead", la), ("lookup", lu)):
        _build.reset_counts()
        e.generate(ids, max_new_tokens=RUNTIME_NEW, stop_at_eos=False)
        for k, v in _build.launches.items():
            launches[k] = launches.get(k, 0) + v

    oracle = LookupEngine(eng.params, eng.model_cfg, n_draft=LOOKUP_K, max_seq=2048,
                          eos_id=eng.tokenizer.eos_id)
    oracle.ngram.update(list(ids) + greedy)
    real = lookup_mod.prompt_lookup_draft
    lookup_mod.prompt_lookup_draft = lambda *a, **k: []
    try:
        oracle.generate(ids, max_new_tokens=RUNTIME_NEW, stop_at_eos=False)  # the captures
        (toks, stats), ttft, after, _, _ = timed_run(lambda cb: oracle.generate(
            ids, max_new_tokens=RUNTIME_NEW, stop_at_eos=False, on_token=cb))
    finally:
        lookup_mod.prompt_lookup_draft = real
    out["oracle_lookup"] = dict(stats=stats, tokens_per_s=(RUNTIME_NEW - 1) / after,
                                ttft_ms=ttft * 1e3, near_tie=check_near_tie(
                                    gen, ids, greedy, toks[:len(greedy)], "runtime",
                                    "oracle lookup vs greedy"))
    log(f"[runtime oracle lookup] drafts = the greedy continuation: mean_accept_len "
        f"{stats['mean_accept_len']:.2f} over {stats['n_cycles']} cycles, "
        f"{out['oracle_lookup']['tokens_per_s']:.1f} t/s graphed (the upper bound)")
    gd = out["greedy_step_ms"]
    log(f"[runtime] device ms: greedy step {gd:.3f}, lookahead step "
        f"{out['lookahead']['device_ms_per_step']:.3f} ({LOOKAHEAD_ROWS} rows), lookup cycle "
        f"{out['lookup']['device_ms_per_step']:.3f} ({LOOKUP_K + 1} rows)")
    out["kernels"] = runtime_kernels(eng.params, torch.Generator(device="cuda").manual_seed(23))
    del eng, gen, la, lu, oracle
    gc.collect()
    torch.cuda.empty_cache()
    return out, launches


def yarn_inv_freq_np(head_dim: int, base: float, factor: float, orig: int):
    """inv_freq of a YaRN config in f64 by the reference's formula
    (ggml_rope_yarn_corr_dims and the ramp blend), written out here."""
    import math

    import numpy as np

    def corr(n_rot):
        return head_dim * math.log(orig / (n_rot * 2.0 * math.pi)) / (2.0 * math.log(base))

    low = max(0.0, float(math.floor(corr(32.0))))
    high = min(float(head_dim - 1), float(math.ceil(corr(1.0))))
    i = np.arange(head_dim // 2, dtype=np.float64)
    ramp = 1.0 - np.clip((i - low) / max(0.001, high - low), 0.0, 1.0)
    blend = (1.0 / factor) * (1.0 - ramp) + ramp
    return (1.0 / base ** (np.arange(0, head_dim, 2, dtype=np.float64) / head_dim)) * blend


def yarn_cell(tmp: pathlib.Path) -> tuple[dict, dict]:
    """(b) A Yarn-Llama-2-7b-64k-shape GGUF (Llama-2-7B widths and depth, Q4_0
    as phase 6's target, 32,000 SPM pieces, context 65,536, YaRN factor 16
    over 4,096), minted, loaded and deleted: its blend against the formula
    on the host; greedy `Generator` at max_seq 8,192 on a 5,000-token
    prompt (bucket 8,192: 129 qmm_tc and 32 flash_prefill at 8,192 rows),
    64 tokens eager and graphed (bit for bit); TTFT, t/s, device ms per
    token at that context; a context shift (keep 64, discard 1,024) against
    a recompute: the moved keys rotated by the formula's frequencies from
    the cache before it (within one bf16 step), and the next token's
    logits on the shifted cache against those on the recomputed one (rel
    err <= 1e-2); flash_decode at T = 1 over that context and flash_prefill
    at T = 8,192 against their plain versions, timed. Returns (the cell,
    the launches of the graphed run)."""
    import gc
    import shutil

    import numpy as np
    import torch
    import torch.nn.functional as F

    from eagle_tpu_torch import _build
    from eagle_tpu_torch.models.loader import load_llama_params
    from eagle_tpu_torch.ops import flash_attention as fa
    from eagle_tpu_torch.ops.rope import rope_freqs_cfg, rope_mscale_cfg
    from eagle_tpu_torch.quant.serving import prepare_params_for_serving
    from eagle_tpu_torch.runtime.generate import Generator

    if shutil.disk_usage(tmp).free < GGUF_FREE_BYTES:
        raise RuntimeError("the YaRN file needs 5 GiB of disk")
    t0 = time.time()
    path, _ = mint_gguf_pair(tmp, seed=31, tag="yarn-llama-2-7b-64k", ctx=65536,
                             metadata=YARN_MD, with_draft=False)
    out: dict = {"mint_s": time.time() - t0}
    t0 = time.time()
    params, cfg, _ = load_llama_params(path, device="cuda")
    params = prepare_params_for_serving(params, "f32")
    torch.cuda.synchronize()
    out["load_s"] = time.time() - t0
    path.unlink()
    if (cfg.rope_scaling, cfg.rope_scale_factor, cfg.rope_orig_ctx, cfg.n_ctx_train) != (
            "yarn", 16.0, 4096, 65536):
        raise AssertionError(f"YaRN keys not read: {cfg}")
    inv, ms = rope_freqs_cfg(cfg, device="cuda")
    want_inv = yarn_inv_freq_np(cfg.rope_dim, cfg.rope_base, 16.0, 4096)
    blend_err = float(np.abs(inv.double().cpu().numpy() / want_inv - 1).max())
    if blend_err > 1e-6 or abs(ms - (1 + 0.1 * np.log(16.0))) > 1e-12:
        raise AssertionError(f"YaRN blend off the formula: rel {blend_err:.2e}, mscale {ms}")
    log(f"[runtime yarn] minted in {out['mint_s']:.1f} s, loaded in {out['load_s']:.1f} s; the "
        f"blended frequencies == the formula's (rel {blend_err:.1e}), mscale {ms:.6f}")

    prompt = np.random.default_rng(7).integers(3, cfg.vocab_size, size=YARN_PROMPT).tolist()
    gen = Generator(params, cfg, max_seq=YARN_SEQ, eos_id=-1)

    def run(on_token):
        return gen.generate(prompt, max_new_tokens=YARN_NEW, stop_at_eos=False,
                            on_token=on_token)

    want = eager_tokens(gen, lambda: run(None))
    if run(None) != want:  # the captures
        raise AssertionError("yarn: graphed tokens differ from eager")
    eager = gen.graphs.eager
    _build.reset_counts()
    toks, ttft, after, at_first, _ = timed_run(run)
    launches = {k: v for k, v in _build.launches.items() if v}
    expect = {"qmm_tc": 129, "flash_prefill": 32, "qmm_gemv": 129 * (YARN_NEW - 1),
              "flash_decode": 32 * (YARN_NEW - 1)}
    if toks != want or gen.graphs.eager != eager or launches != expect or any(
            _build.plain_calls.values()):
        raise AssertionError(f"yarn: graphed run differs or launches {launches} != {expect}")
    step_ms = decode_device_ms(gen, prompt)
    out.update(ttft_ms=ttft * 1e3, tokens_per_s=(YARN_NEW - 1) / after, device_ms_per_token=step_ms,
               launches=launches, distinct_tokens=len(set(want)))
    log(f"[runtime yarn] greedy at max_seq {YARN_SEQ}, a {YARN_PROMPT}-token prompt: graphed == "
        f"eager bit for bit; TTFT {ttft * 1e3:.1f} ms (129 qmm_tc and 32 flash_prefill at 8,192 "
        f"rows), {out['tokens_per_s']:.1f} t/s, device {step_ms:.3f} ms per token at "
        f"{YARN_PROMPT}-{YARN_PROMPT + YARN_NEW} tokens of context")

    # the context shift against a recompute by the formula's frequencies
    keep, discard = YARN_SHIFT
    gen.generate(prompt, max_new_tokens=YARN_NEW, stop_at_eos=False)
    kv, s = gen.kv, YARN_SEQ
    start, m = keep + discard, YARN_SEQ - keep - discard
    k_before = kv.k[:, :, :, start:s].clone()
    t0 = time.perf_counter()
    gen.shift_context(keep, discard)
    torch.cuda.synchronize()
    shift_ms = (time.perf_counter() - t0) * 1e3
    ang = torch.from_numpy(-discard * want_inv).cuda()  # [D/2] f64
    cos, sin = torch.cos(ang).float(), torch.sin(ang).float()
    k1, k2 = k_before.float().chunk(2, dim=-1)
    k_rec = torch.cat([k1 * cos - k2 * sin, k2 * cos + k1 * sin], dim=-1).to(kv.k.dtype)
    del k_before, k1, k2
    key_err = float((kv.k[:, :, :, keep:keep + m].float() - k_rec.float()).abs().max())
    key_scale = float(k_rec.float().abs().max())
    if key_err > 2.0 ** -7 * key_scale:
        raise AssertionError(f"yarn shift: keys {key_err:.3e} off the recompute "
                             f"(scale {key_scale:.3e})")
    nxt = YARN_PROMPT + YARN_NEW - 1 - discard  # the last token was never fed
    shifted = gen._constrained_step(want[-1], nxt)[0].clone()
    kv.k[:, :, :, keep:keep + m] = k_rec
    recomputed = gen._constrained_step(want[-1], nxt)[0].clone()
    abs_err, rel = rel_err(shifted, recomputed)
    if rel > ATTN_TOL or not bool(torch.isfinite(shifted).all()):
        raise AssertionError(f"yarn shift: next logits rel err {rel:.3e} against the recompute")
    out["shift"] = dict(keep=keep, discard=discard, host_ms=shift_ms, key_max_abs_err=key_err,
                        key_scale=key_scale, logits_max_abs_err=abs_err, logits_rel_err=rel)
    log(f"[runtime yarn] context shift keep {keep} discard {discard}: {shift_ms:.2f} ms; keys "
        f"== the recompute within {key_err:.2e} (scale {key_scale:.2e}); the next token's "
        f"logits rel err {rel:.2e} against the recomputed cache")
    del k_rec, gen, params, kv
    gc.collect()
    torch.cuda.empty_cache()

    # flash_decode over that context and flash_prefill at the prompt's bucket
    gen_r = torch.Generator(device="cuda").manual_seed(29)
    h, d, n_ctx = cfg.n_heads, cfg.head_dim, YARN_PROMPT + YARN_NEW
    kc = torch.randn((2, 1, h, s, d), generator=gen_r, device="cuda").to(torch.bfloat16)
    vc = torch.randn((2, 1, h, s, d), generator=gen_r, device="cuda").to(torch.bfloat16)
    tags = torch.arange(s, dtype=torch.int32, device="cuda")[None]
    rows = {}
    q = torch.randn((1, 1, h, d), generator=gen_r, device="cuda")
    dec_tags = torch.where(tags < n_ctx, tags, -1)
    mask = (dec_tags[:, None, :] >= 0) & (dec_tags[:, None, :] <= n_ctx)
    got = fa.flash_attention_cached(q, kc, vc, mask, 1, s_limit=s)
    abs_err, rel = rel_err(got, fa.flash_attention_cached_plain(q, kc, vc, mask, 1, s_limit=s))
    ms_k = device_ms(lambda i: fa.flash_attention_cached(q, kc, vc, mask, i % 2, s_limit=s), 50)
    plain = device_ms(lambda i: fa.flash_attention_cached_plain(q, kc, vc, mask, i % 2,
                                                               s_limit=s), 10)
    qb = q.transpose(1, 2).to(torch.bfloat16)
    lib = device_ms(lambda i: F.scaled_dot_product_attention(
        qb, kc[1, :, :, :s], vc[1, :, :, :s], attn_mask=mask[:, None]), 50)
    b_ms, b_by = bound_ms(2 * h * n_ctx * d * 2 + nbytes(q, mask) + q.numel() * 4,
                          4.0 * h * n_ctx * d)
    rows["flash_decode"] = dict(t=1, s=s, visible=n_ctx, ms=ms_k, plain_ms=plain, bound_ms=b_ms,
                                bound_by=b_by, library_ms=lib, max_abs_err=abs_err, rel_err=rel)
    q = torch.randn((1, s, h, d), generator=gen_r, device="cuda")
    q_pos = tags.clone()
    pre_tags = torch.where(tags < YARN_PROMPT, tags, -1)
    got = fa.flash_attention_prefill(q, kc, vc, q_pos, pre_tags, 1, s_limit=s)
    want_p = fa.flash_attention_prefill_plain(q, kc, vc, q_pos, pre_tags, 1, s_limit=s)
    abs_p, rel_p = rel_err(got, want_p)
    del want_p
    ms_p = device_ms(lambda i: fa.flash_attention_prefill(q, kc, vc, q_pos, pre_tags, i % 2,
                                                         s_limit=s), 5)
    plain_p = device_ms(lambda i: fa.flash_attention_prefill_plain(q, kc, vc, q_pos, pre_tags,
                                                                  i % 2, s_limit=s), 1, warmup=1)
    vis = (pre_tags[:, None, :] >= 0) & (pre_tags[:, None, :] <= q_pos[:, :, None])
    qb = q.transpose(1, 2).to(torch.bfloat16)
    lib_p = device_ms(lambda i: F.scaled_dot_product_attention(
        qb, kc[1], vc[1], attn_mask=vis[:, None]), 3, warmup=1)
    del vis, qb
    bp_ms, bp_by = prefill_bound(q, kc, q_pos, pre_tags, s)
    rows["flash_prefill"] = dict(t=s, s=s, visible=YARN_PROMPT, ms=ms_p, plain_ms=plain_p,
                                 bound_ms=bp_ms, bound_by=bp_by, library_ms=lib_p,
                                 max_abs_err=abs_p, rel_err=rel_p)
    for name, r in rows.items():
        if r["rel_err"] > ATTN_TOL:
            raise AssertionError(f"yarn {name}: rel err {r['rel_err']:.3e}")
        log(f"[runtime kernel] {name} T={r['t']} S={s} ({r['visible']} visible slots) H={h} "
            f"D={d}  kernel {r['ms']:.4f} ms  plain {r['plain_ms']:.4f} ms  bound "
            f"{r['bound_ms'] * 1e3:.2f} us ({r['bound_by']})  library {r['library_ms']:.4f} ms  "
            f"rel err {r['rel_err']:.2e}")
    out["kernels"] = rows
    del kc, vc, q
    gc.collect()
    torch.cuda.empty_cache()
    return out, launches


def codellama_vocab(seed: int) -> dict:
    """`spm_vocab` at CodeLlama-7b's 32,016 pieces with its FIM control pieces
    and their GGUF keys."""
    import numpy as np

    md = spm_vocab(32016, seed)
    toks = list(md["tokenizer.ggml.tokens"])
    ttype = np.asarray(md["tokenizer.ggml.token_type"]).copy()
    for name, (i, piece) in FIM_PIECES.items():
        toks[i] = piece
        ttype[i] = 3  # control
        md[f"tokenizer.ggml.{name}_token_id"] = i
    md["tokenizer.ggml.tokens"] = toks
    md["tokenizer.ggml.token_type"] = ttype
    return md


def infill_http(path, plain_target, want: str) -> dict:
    """The server (`-np 1`) on the CodeLlama file and on phase 6's target
    (no FIM tokens) as subprocesses started together: /infill on the first
    answers the in-process PSM text, on the second 400; SIGTERM exit 0."""
    import signal
    import socket
    import urllib.error
    import urllib.request

    env = {k: v for k, v in os.environ.items() if k != "EAGLE_TPU_FUSED_FFN"}
    cwd = pathlib.Path(__file__).resolve().parent
    servers = {}
    t0 = time.time()
    for name, model in (("codellama", path), ("no_fim", plain_target)):
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        proc = subprocess.Popen(
            [sys.executable, "-m", "eagle_tpu_torch.server.server", "-m", str(model), "-np", "1",
             "--host", "127.0.0.1", "--port", str(port)], cwd=cwd, env=env,
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
        servers[name] = (proc, f"http://127.0.0.1:{port}")
    body = {"input_prefix": INFILL_TEXT[0], "input_suffix": INFILL_TEXT[1],
            "n_predict": INFILL_NEW}
    out: dict = {}
    try:
        for name, (proc, url) in servers.items():
            while True:
                if proc.poll() is not None:
                    raise AssertionError(f"server {name} exited {proc.returncode}: "
                                         f"{proc.stderr.read()[-3000:]}")
                try:
                    urllib.request.urlopen(url + "/health", timeout=2)
                    break
                except OSError:
                    if time.time() - t0 > 300:
                        raise
                    time.sleep(0.25)
            req = urllib.request.Request(url + "/infill", json.dumps(body).encode(),
                                         {"Content-Type": "application/json"})
            t1 = time.time()
            try:
                with urllib.request.urlopen(req, timeout=600) as r:
                    out[name] = (r.status, json.loads(r.read()))
            except urllib.error.HTTPError as e:
                out[name] = (e.code, json.loads(e.read()))
            out[f"{name}_s"] = time.time() - t1
    finally:
        for proc, _ in servers.values():
            if proc.poll() is None:
                proc.send_signal(signal.SIGTERM)
        for name, (proc, _) in servers.items():
            try:
                _, err = proc.communicate(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                _, err = proc.communicate()
            if proc.returncode != 0 or "Traceback" in err:
                raise AssertionError(f"server {name}: exit {proc.returncode}, {err[-3000:]}")
    if out["codellama"] != (200, {"content": want, "stop": True}):
        raise AssertionError(f"/infill: {out['codellama']!r}, in process {want!r}")
    status, err = out["no_fim"]
    if status != 400 or "FIM" not in err.get("error", ""):
        raise AssertionError(f"/infill without FIM tokens: {out['no_fim']!r}")
    out["seconds"] = time.time() - t0
    log(f"[runtime infill http] /infill content == the in-process call ({out['codellama_s']:.2f} "
        f"s); a target without FIM tokens answers 400 ({err['error']!r}); SIGTERM exit 0; "
        f"{out['seconds']:.1f} s in all")
    return out


def infill_cell(tmp: pathlib.Path, plain_target) -> tuple[dict, dict]:
    """(c) A CodeLlama-7b-shape GGUF (Llama-2-7B widths and depth, Q4_0, rope
    base 1,000,000, context 16,384, 32,016 SPM pieces with the FIM control
    pieces at 32007-32010 and their keys), minted: `Engine.infill` greedy
    in PSM and SPM order, 32 tokens, eager once and graphed twice (the
    same tokens bit for bit); wall ms per token and the infill filter's
    host ms per token; a step's launches 129 qmm_gemv and 32 flash_decode;
    the engine freed, `infill_http`; the file deleted. Returns (the cell,
    the launches of the graphed PSM run)."""
    import gc
    import shutil

    import torch

    from eagle_tpu_torch import _build
    from eagle_tpu_torch.api import Engine, EngineConfig
    from eagle_tpu_torch.runtime import infill as infill_mod

    if shutil.disk_usage(tmp).free < GGUF_FREE_BYTES:
        raise RuntimeError("the CodeLlama file needs 5 GiB of disk")
    t0 = time.time()
    path, _ = mint_gguf_pair(tmp, seed=41, tag="codellama-7b", v=32016, ctx=16384,
                             rope_base=1e6, vocab=codellama_vocab(41), with_draft=False)
    out: dict = {"mint_s": time.time() - t0}
    eng = Engine(EngineConfig(model_path=path, max_seq=2048))
    gen = eng.engine
    filt = {"calls": 0, "s": 0.0}
    real_filter = infill_mod.infill_filter

    def timed_filter(*a, **k):
        t1 = time.perf_counter()
        try:
            return real_filter(*a, **k)
        finally:
            filt["s"] += time.perf_counter() - t1
            filt["calls"] += 1

    fed: list = []
    real_step = gen._constrained_step

    def step(tok, pos):
        fed.append(tok)
        return real_step(tok, pos)

    infill_mod.infill_filter = timed_filter
    gen._constrained_step = step
    launches = {}
    try:
        for order in ("psm", "spm"):
            kw = dict(max_new_tokens=INFILL_NEW, spm_infill=order == "spm")
            fed.clear()
            want = eager_tokens(gen, lambda: eng.infill(*INFILL_TEXT, **kw))
            want_fed = list(fed)
            runs = []
            for i in range(2):  # the capture, then the timed run
                fed.clear()
                filt.update(calls=0, s=0.0)
                _build.reset_counts()
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                text = eng.infill(*INFILL_TEXT, **kw)
                wall = time.perf_counter() - t1
                runs.append(text)
                if text != want or fed != want_fed:
                    raise AssertionError(f"infill {order}: graphed tokens differ from eager")
            n_tok = len(fed)  # every output token is fed for the next one's logits
            got = {k: v for k, v in _build.launches.items() if v}
            for key, g in gen.graphs._graphs.items():
                if key[0][0] == "logits" and {k: v for k, v in g.counts.items() if v} != {
                        "qmm_gemv": 129, "flash_decode": 32}:
                    raise AssertionError(f"infill: a step's launches {g.counts}")
            if order == "psm":
                launches = got
            out[order] = dict(text=want, tokens=n_tok, wall_ms_per_token=wall * 1e3 / n_tok,
                              filter_host_ms_per_token=filt["s"] * 1e3 / max(1, filt["calls"]),
                              launches=got)
            log(f"[runtime infill] {order.upper()}: graphed == eager bit for bit, {n_tok} "
                f"tokens ({want[:60]!r}...); wall {out[order]['wall_ms_per_token']:.2f} ms per "
                f"token, the infill filter {out[order]['filter_host_ms_per_token']:.2f} ms of it "
                f"on the host; per token 129 qmm_gemv and 32 flash_decode")
            if n_tok < 4:
                raise AssertionError(f"infill {order}: the fill ended after {n_tok} tokens")
    finally:
        infill_mod.infill_filter = real_filter
    del eng, gen, real_step
    gc.collect()
    torch.cuda.empty_cache()
    out["http"] = infill_http(path, plain_target, out["psm"]["text"])
    path.unlink()
    log(f"[runtime infill] minted in {out['mint_s']:.1f} s")
    return out, launches


def runtime_path(report: dict, target, tmp: pathlib.Path) -> dict:
    """Phase runtime: `lookahead_lookup`, `yarn_cell`, `infill_cell`.
    Returns the launches of the path's graphed runs (a lookahead and a
    lookup run, the YaRN run, the PSM infill), counted from 0 before each."""
    out, launches = {}, {}
    out["model_free"], la = lookahead_lookup(report, target, tmp)
    out["yarn"], ya = yarn_cell(tmp)
    out["infill"], inf = infill_cell(tmp, target)
    for part in (la, ya, inf):
        for k, v in part.items():
            launches[k] = launches.get(k, 0) + v
    out["launches"] = launches
    report["runtime_path"] = out
    return launches


# --------------------------------------------------------------------------
# phase llama3: the Llama-3 family at Meta-Llama-3.1-8B-Instruct's shape


#: Meta-Llama-3.1-8B-Instruct (its config.json) and Llama-3.2-3B-Instruct's,
#: at 16 of 32 and 14 of 28 layers to fit the script's time
LLAMA3_8B = dict(d=4096, f=14336, v=128256, n_layers=16, n_heads=32, n_kv_heads=8,
                 ctx=131072, rope_base=500000.0)
LLAMA3_3B = dict(d=3072, f=8192, v=128256, n_layers=14, n_heads=24, n_kv_heads=8,
                 ctx=131072, rope_base=500000.0)
#: rope_scaling of the two configs: (factor, low_freq_factor, high_freq_factor, original ctx)
LLAMA31_ROPE = (8.0, 1.0, 4.0, 8192)
LLAMA32_ROPE = (32.0, 1.0, 4.0, 8192)
LLAMA3_PROMPT_TOKENS = 300
LLAMA3_NEW = 64
LLAMA3_CLI_NEW = 32
LLAMA3_CHAT_SEQ = 512  # the chat session's cache: its third turn shifts
LLAMA3_CHAT_WORDS = (70, 35, 80)  # the user turns, in vocabulary words (~2.7 tokens each)
LLAMA3_CHAT_NEW = 48
#: named specials of Llama-3.1's 256 (the rest are reserved_special_token_N)
LLAMA3_SPECIALS = {128000: "<|begin_of_text|>", 128001: "<|end_of_text|>",
                   128004: "<|finetune_right_pad_id|>", 128006: "<|start_header_id|>",
                   128007: "<|end_header_id|>", 128008: "<|eom_id|>", 128009: "<|eot_id|>",
                   128010: "<|python_tag|>"}
LLAMA3_TEMPLATE = ("{{- bos_token }}{%- for message in messages %}{{- '<|start_header_id|>' + "
                   "message['role'] + '<|end_header_id|>\\n\\n' + message['content'] | trim + "
                   "'<|eot_id|>' }}{%- endfor %}{%- if add_generation_prompt %}{{- "
                   "'<|start_header_id|>assistant<|end_header_id|>\\n\\n' }}{%- endif %}")
#: per decoded 8B token: 4 stacked products a layer + lm_head; per 3B
#: token the same without a head (the tied head is no qmm)
LLAMA3_GEMV = LLAMA3_8B["n_layers"] * 4 + 1
TIED_GEMV = LLAMA3_3B["n_layers"] * 4


def llama3_factors(head_dim: int, base: float, factor: float, low: float, high: float,
                   orig: int):
    """Llama-3.1's `rope_freqs.weight` (f32): convert_hf_to_gguf's llama3
    rule, written out here (the frequencies in f32, as the converter)."""
    import math

    import numpy as np

    out = []
    for f in 1.0 / (base ** (np.arange(0, head_dim, 2, dtype=np.float32) / head_dim)):
        wl = 2 * math.pi / f
        if wl < orig / high:
            out.append(1.0)
        elif wl > orig / low:
            out.append(factor)
        else:
            smooth = (orig / wl - low) / (high - low)
            out.append(1.0 / ((1 - smooth) / factor + smooth))
    return np.asarray(out, np.float32)


def bpe_pieces(seed: int, n_pieces: int) -> tuple[list, list, list]:
    """(pieces, merges, words) of a byte-level BPE vocabulary: the 256 byte
    symbols, then seeded words (ASCII letters, a few accented and CJK
    characters; 70 % with a leading space) each merged left to right, every
    new prefix a piece and its merge the next rank, up to `n_pieces`."""
    import numpy as np

    from eagle_tpu_torch.tokenizer.bpe import _BYTE_ENC

    rng = np.random.default_rng(seed)
    pieces = [_BYTE_ENC[b] for b in range(256)]
    seen, merges, words = set(pieces), [], []
    chars = np.array(list("abcdefghijklmnopqrstuvwxyz") * 4 + list("éüßçñ日本語中文字"))
    while len(pieces) < n_pieces:
        word = "".join(chars[rng.integers(0, len(chars), int(rng.integers(2, 9)))])
        words.append(word)
        sym = [_BYTE_ENC[b] for b in ((" " if rng.random() < 0.7 else "") + word).encode()]
        cur = sym[0]
        for s in sym[1:]:
            if cur + s not in seen and len(pieces) < n_pieces:
                seen.add(cur + s)
                pieces.append(cur + s)
                merges.append(f"{cur} {s}")
            cur = cur + s
    return pieces, merges, words


def bpe_vocab(seed: int, v: int, n_pieces: int, specials: tuple, pre: str) -> tuple[dict, list]:
    """A byte-level BPE vocabulary of `v` entries as GGUF metadata, and its
    words: `bpe_pieces` up to `n_pieces`, then `specials` (control), then
    [PAD] pieces to `v` (control); pre `pre`, BOS and EOS the first special,
    no BOS added, no chat template."""
    import numpy as np

    pieces, merges, words = bpe_pieces(seed, n_pieces)
    rest = list(specials) + [f"[PAD{i}]" for i in range(v - n_pieces - len(specials))]
    md = {"tokenizer.ggml.model": "gpt2", "tokenizer.ggml.pre": pre,
          "tokenizer.ggml.tokens": pieces + rest, "tokenizer.ggml.merges": merges,
          "tokenizer.ggml.token_type": np.asarray([1] * n_pieces + [3] * len(rest), np.int32),
          "tokenizer.ggml.bos_token_id": n_pieces, "tokenizer.ggml.eos_token_id": n_pieces,
          "tokenizer.ggml.add_bos_token": False}
    return md, words


def llama3_vocab(seed: int, v: int = 128256) -> tuple[dict, list]:
    """A Llama-3-layout byte-level BPE vocabulary as GGUF metadata, and the
    words it was built from: `bpe_pieces` up to 128,000 pieces; Llama-3.1's
    256 specials at 128,000-128,255 (control); pre "llama-bpe", BOS
    <|begin_of_text|>, EOS and EOT <|eot_id|> (the Instruct files'), a
    template with Llama-3's header markers."""
    import numpy as np

    n_pieces = v - 256
    pieces, merges, words = bpe_pieces(seed, n_pieces)
    specials = [LLAMA3_SPECIALS.get(i, f"<|reserved_special_token_{i - 128000}|>")
                for i in range(n_pieces, v)]
    md = {"tokenizer.ggml.model": "gpt2", "tokenizer.ggml.pre": "llama-bpe",
          "tokenizer.ggml.tokens": pieces + specials, "tokenizer.ggml.merges": merges,
          "tokenizer.ggml.token_type": np.asarray([1] * n_pieces + [3] * 256, np.int32),
          "tokenizer.ggml.bos_token_id": 128000, "tokenizer.ggml.eos_token_id": 128009,
          "tokenizer.ggml.eot_token_id": 128009, "tokenizer.ggml.add_bos_token": True,
          "tokenizer.chat_template": LLAMA3_TEMPLATE}
    return md, words


def llama3_text(tok, words: list, n_tokens: int, seed: int) -> str:
    """Seeded vocabulary words with digits, punctuation and multi-byte words
    between them, grown until the text encodes to at least `n_tokens`."""
    import numpy as np

    rng = np.random.default_rng(seed)
    extra = ["naïve", "café", "日本語", "Straße", "😀", "3.14", "don't", ",", "."]
    parts: list = []
    while True:
        for _ in range(16):
            parts.append(str(extra[rng.integers(0, len(extra))]) if rng.random() < 0.15
                         else words[int(rng.integers(0, len(words)))])
        text = " ".join(parts)
        if len(tok.encode(text)) >= n_tokens:
            return text


def llama3_qmm_checks(params, draft, gen) -> dict:
    """qmm at the 8B path's new shapes on each route, against the plain
    version: the target's wqkv (N 6,144), wo, w_gate_up (N 28,672), w_down
    (K 14,336) and its Q6_K lm_head (N 128,256) at 1 row (`qmm_gemv`, per
    decoded token), 6 rows (`qmm_mma`, per verify cycle) and 300 rows
    (`qmm_tc`, a prompt's), and the draft's Q8_0 fc (K 8,192) at the same
    rows; each timed with its bound and library ms."""
    rows_out: list = []
    specs = target_qmm_specs(params)
    totals = {}
    for rows, route, what in ((1, "qmm_gemv", "decoded token"), (VERIFY_ROWS, "qmm_mma",
                                                                 "verify cycle"),
                              (LLAMA3_PROMPT_TOKENS, "qmm_tc", "300-row prompt")):
        totals[what] = qmm_sum("llama3 kernel", what, rows, specs, route, gen, rows_out)
        qmm_sum("llama3 kernel", f"draft fc at {rows} rows", rows,
                [("draft fc", draft["fc_w"], 1)], route, gen, rows_out)
    return dict(rows=rows_out, totals=totals)


def llama3_ffn_checks(draft, gen) -> list:
    """ffn_out_norm and gate_up_act at n_ff 14,336 on the draft's Q8_0 layer
    (the form the fused kernels take on this path), 1 and 6 rows, against
    their plain versions, timed with bound and library ms (torch.matmul on
    the dequantized bf16 weight: the product alone)."""
    import torch

    from eagle_tpu_torch.ops.ffn import (ffn_out_norm, ffn_out_norm_plain, gate_up_act,
                                         gate_up_act_plain)

    lay, bf16, eps = draft["layers"], torch.bfloat16, 1e-6
    out = []
    for name, w in (("ffn_out_norm", lay["wo"]), ("gate_up_act", lay["w_gate_up"])):
        n, k = w.layer(0).shape
        dense = w.layer(0).dequantize(bf16).T.contiguous()
        for rows in (1, VERIFY_ROWS):
            if name == "ffn_out_norm":
                attn = torch.randn((rows, k), generator=gen, device="cuda")
                resid = torch.randn((rows, n), generator=gen, device="cuda")
                nw = lay["ffn_norm"][0]
                got = ffn_out_norm(attn, resid, nw, w, 0, eps, bf16)
                want = ffn_out_norm_plain(attn, resid, nw, w.layer(0), eps, bf16)
                run = lambda i: ffn_out_norm(attn, resid, nw, w, 0, eps, bf16)
                plain_run = lambda i: ffn_out_norm_plain(attn, resid, nw, w.layer(0), eps, bf16)
                lib_in, io = attn.to(bf16), rows * k * 4 + 2 * rows * n * 4 + n * 4 + rows * n * 2
            else:
                hin = torch.randn((rows, k), generator=gen, device="cuda").to(bf16)
                got = (gate_up_act(hin, w, 0, "silu", bf16),)
                want = (gate_up_act_plain(hin, w.layer(0), "silu", bf16),)
                run = lambda i: gate_up_act(hin, w, 0, "silu", bf16)
                plain_run = lambda i: gate_up_act_plain(hin, w.layer(0), "silu", bf16)
                lib_in, io = hin, rows * k * 2 + rows * n // 2 * 2
            abs_err = rel = 0.0
            for g, ww in zip(got, want):
                a, r = rel_err(g, ww)
                abs_err, rel = max(abs_err, a), max(rel, r)
                if not bool(torch.isfinite(g).all()):
                    raise AssertionError(f"llama3 {name} rows={rows}: non-finite output")
            if rel > QMM_TOL:
                raise AssertionError(f"llama3 {name} rows={rows}: rel err {rel:.3e}")
            ms = device_ms(run, 20)
            plain = device_ms(plain_run, 3, warmup=1)
            lib = device_ms(lambda i: torch.matmul(lib_in, dense), 20)
            b_ms, b_by = bound_ms(nbytes(*w.layer(0).tensors().values()) + io, 2.0 * rows * k * n)
            out.append(dict(name=name, form="q8_0_draft", n=n, k=k, rows=rows, ms=ms,
                            plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=lib,
                            max_abs_err=abs_err, rel_err=rel))
            log(f"[llama3 kernel] {name:12s} Q8_0 draft N={n:5d} K={k:5d} rows={rows}  kernel "
                f"{ms:.4f} ms  plain {plain:.3f} ms  bound {b_ms * 1e3:.2f} us ({b_by})  library "
                f"{lib:.4f} ms  rel err {rel:.2e}")
        del dense
    torch.cuda.empty_cache()
    return out


def gqa_flash_checks(gen, tag: str, h: int, h_kv: int, d: int = 128) -> list:
    """flash_decode at T = 1 and 6 over S = 1,024 (900 tokens, a hole) and
    flash_prefill at T = 512 (300 real rows) at h query heads over h_kv KV
    heads of `d` (g = h / h_kv; bf16 cache), against their plain versions,
    timed; the library is SDPA with `enable_gqa`."""
    import torch
    import torch.nn.functional as F

    from eagle_tpu_torch.ops import flash_attention as fa
    from eagle_tpu_torch.runtime.kvcache import causal_mask_from_tags

    b, s, layer, g = 1, 1024, 1, h // h_kv
    kc = torch.randn((2, b, h_kv, s, d), generator=gen, device="cuda").to(torch.bfloat16)
    vc = torch.randn((2, b, h_kv, s, d), generator=gen, device="cuda").to(torch.bfloat16)
    out = []
    for t in (1, VERIFY_ROWS):
        tags = torch.full((b, s), -1, dtype=torch.int32, device="cuda")
        tags[:, :900 + t] = torch.arange(900 + t, dtype=torch.int32, device="cuda")
        tags[:, 100:140] = -1
        pos = (900 + torch.arange(t, dtype=torch.int32, device="cuda"))[None]
        mask = causal_mask_from_tags(tags, pos)
        q = torch.randn((b, t, h, d), generator=gen, device="cuda")
        got = fa.flash_attention_cached(q, kc, vc, mask, layer, s_limit=s)
        abs_err, rel = rel_err(got, fa.flash_attention_cached_plain(q, kc, vc, mask, layer,
                                                                    s_limit=s))
        ms = device_ms(lambda i: fa.flash_attention_cached(q, kc, vc, mask, layer, s_limit=s), 50)
        plain = device_ms(lambda i: fa.flash_attention_cached_plain(q, kc, vc, mask, layer,
                                                                   s_limit=s), 10)
        qb = q.transpose(1, 2).to(torch.bfloat16)
        lib = device_ms(lambda i: F.scaled_dot_product_attention(
            qb, kc[layer], vc[layer], attn_mask=mask[:, None], enable_gqa=True), 50)
        b_ms, b_by = bound_ms(2 * b * h_kv * s * d * 2 + nbytes(q, mask) + q.numel() * 4,
                              4.0 * b * h * t * s * d)
        out.append(dict(name="flash_decode", g=g, d=d, t=t, s=s, ms=ms, plain_ms=plain,
                        bound_ms=b_ms, bound_by=b_by, library_ms=lib, max_abs_err=abs_err,
                        rel_err=rel))
    t, n, lim = 512, LLAMA3_PROMPT_TOKENS, 512
    tags = torch.full((b, s), -1, dtype=torch.int32, device="cuda")
    tags[:, :n] = torch.arange(n, dtype=torch.int32, device="cuda")
    q_pos = torch.arange(t, dtype=torch.int32, device="cuda")[None].clone()
    q = torch.randn((b, t, h, d), generator=gen, device="cuda")
    got = fa.flash_attention_prefill(q, kc, vc, q_pos, tags, layer, s_limit=lim)
    abs_err, rel = rel_err(got, fa.flash_attention_prefill_plain(q, kc, vc, q_pos, tags, layer,
                                                                 s_limit=lim))
    ms = device_ms(lambda i: fa.flash_attention_prefill(q, kc, vc, q_pos, tags, layer,
                                                       s_limit=lim), 10)
    plain = device_ms(lambda i: fa.flash_attention_prefill_plain(q, kc, vc, q_pos, tags, layer,
                                                                s_limit=lim), 5)
    vis = (tags[:, None, :lim] >= 0) & (tags[:, None, :lim] <= q_pos[:, :, None])
    qb = q.transpose(1, 2).to(torch.bfloat16)
    lib = device_ms(lambda i: F.scaled_dot_product_attention(
        qb, kc[layer, :, :, :lim], vc[layer, :, :, :lim], attn_mask=vis[:, None],
        enable_gqa=True), 10)
    b_ms, b_by = prefill_bound(q, kc, q_pos, tags, lim)
    out.append(dict(name="flash_prefill", g=g, d=d, t=t, s=lim, ms=ms, plain_ms=plain,
                    bound_ms=b_ms, bound_by=b_by, library_ms=lib, max_abs_err=abs_err,
                    rel_err=rel))
    for r in out:
        if r["rel_err"] > ATTN_TOL:
            raise AssertionError(f"{tag} {r['name']} g={g} T={r['t']}: rel err "
                                 f"{r['rel_err']:.3e}")
        log(f"[{tag}] {r['name']} g={g} T={r['t']} (T*g={r['t'] * g}) S={r['s']} H={h}/{h_kv} "
            f"D={d}  kernel "
            f"{r['ms']:.4f} ms  plain {r['plain_ms']:.4f} ms  bound {r['bound_ms'] * 1e3:.2f} us "
            f"({r['bound_by']})  library {r['library_ms']:.4f} ms  rel err {r['rel_err']:.2e}")
    del kc, vc
    torch.cuda.empty_cache()
    return out


def cli_server_subprocesses(target, draft, text: str, eng, tmp: pathlib.Path,
                            tag: str = "llama3", template: str = "llama3") -> dict:
    """The CLI (`--draft` unless `draft` is None, `--temp 0`) and the server
    (`-np 1`) as subprocesses at once: the CLI's text and the server's
    /v1/chat/completions content (the GGUF's template, read as `template`;
    a system and a user message with multi-byte characters) must equal the
    in-process greedy `Engine`'s on the same prompts; SIGTERM ends the
    server with exit 0."""
    import signal
    import socket
    import urllib.request

    from eagle_tpu_torch.server.chat_templates import apply_template, detect_template

    src = eng.metadata.get("tokenizer.chat_template")
    if detect_template(src) != template:
        raise AssertionError(f"{tag}: the GGUF's template is not detected as {template}")
    with_draft = ["--draft", str(draft)] if draft is not None else []
    env = {k: v for k, v in os.environ.items() if k != "EAGLE_TPU_FUSED_FFN"}
    cwd = pathlib.Path(__file__).resolve().parent
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    err_path = tmp / f"{tag}-server.stderr"
    t0 = time.time()
    cli = subprocess.Popen(
        [sys.executable, "-m", "eagle_tpu_torch.tools.cli", "-m", str(target), *with_draft,
         "-p", text, "-n", str(LLAMA3_CLI_NEW), "--temp", "0"],
        cwd=cwd, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    with open(err_path, "w") as err:
        srv = subprocess.Popen(
            [sys.executable, "-m", "eagle_tpu_torch.server.server", "-m", str(target),
             *with_draft, "-np", "1", "--host", "127.0.0.1", "--port", str(port)],
            cwd=cwd, env=env, stdout=subprocess.DEVNULL, stderr=err)
    try:
        stdout, stderr = cli.communicate(timeout=600)
        cli_s = time.time() - t0
        spec = [ln for ln in stderr.splitlines() if ln.startswith("[speculative]")]
        if cli.returncode != 0 or (draft is not None and not spec):
            raise AssertionError(f"{tag} cli: exit {cli.returncode}: {stderr[-2000:]}")
        want_cli, _ = eng.generate_text(text, max_new_tokens=LLAMA3_CLI_NEW)
        if stdout.rstrip("\n") != want_cli:
            raise AssertionError(f"{tag} cli: {stdout[:200]!r} != in-process {want_cli[:200]!r}")
        while True:
            if srv.poll() is not None:
                raise AssertionError(f"{tag} server exited {srv.returncode}: "
                                     f"{err_path.read_text()[-3000:]}")
            try:
                urllib.request.urlopen(f"http://127.0.0.1:{port}/health", timeout=2)
                break
            except OSError:
                if time.time() - t0 > 300:
                    raise
                time.sleep(0.25)
        msgs = [{"role": "system", "content": "Réponds en français, s'il te plaît."},
                {"role": "user", "content": text[:200] + " 日本語?"}]
        body = {"messages": msgs, "max_tokens": 24, "temperature": 0}
        req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/chat/completions",
                                     json.dumps(body).encode(),
                                     {"Content-Type": "application/json"})
        t1 = time.time()
        with urllib.request.urlopen(req, timeout=300) as r:
            got = json.loads(r.read())["choices"][0]["message"]["content"]
        http_s = time.time() - t1
        rendered = apply_template(msgs, jinja_src=src)
        want, _ = eng.generate_text(rendered, max_new_tokens=24)
        if got != want.strip():
            raise AssertionError(f"{tag} server: {got[:200]!r} != in-process {want[:200]!r}")
        srv.send_signal(signal.SIGTERM)
        rc = srv.wait(timeout=60)
        if rc != 0 or "Traceback" in err_path.read_text():
            raise AssertionError(f"{tag} server: SIGTERM exit {rc}: "
                                 f"{err_path.read_text()[-2000:]}")
    finally:
        for p in (cli, srv):
            if p.poll() is None:
                p.kill()
                p.wait()
    log(f"[{tag} cli] {' '.join(with_draft[:1])} --temp 0: exit 0 in {cli_s:.1f} s"
        + (f", {spec[0]}" if spec else "") + f"; text == the in-process Engine's "
        f"({len(want_cli)} characters)")
    n_prompt = len(eng.tokenizer.encode(rendered))
    log(f"[{tag} http] /v1/chat/completions ({template} template, {n_prompt} prompt tokens): "
        f"content == the in-process Engine's, {http_s:.2f} s; SIGTERM exit 0")
    return dict(cli_s=cli_s, cli_text=want_cli, http_s=http_s, http_content=got)


def llama3_chat_shift(eng, words: list) -> dict:
    """`ChatSession` (the GGUF's llama3 template) on a 512-slot `Generator`
    over three turns; the third shifts the context. At each shift the moved
    keys must equal the keys before it rotated by -discard with Llama-3.1's
    factored frequencies by the formula (f64 on the host: base^(-2i/d) /
    factors), within one bf16 step; graphed == eager tokens."""
    import numpy as np
    import torch

    from eagle_tpu_torch.runtime.chat import ChatSession
    from eagle_tpu_torch.runtime.generate import Generator

    cfg = eng.model_cfg
    inv = (1.0 / cfg.rope_base ** (np.arange(0, cfg.head_dim, 2, dtype=np.float64)
                                   / cfg.head_dim)) / llama3_factors(cfg.head_dim,
                                                                     cfg.rope_base,
                                                                     *LLAMA31_ROPE)
    rng = np.random.default_rng(41)
    texts = [" ".join(words[i] for i in rng.integers(0, len(words), n)) + " naïve 日本語?"
             for n in LLAMA3_CHAT_WORDS]
    kw = dict(eng._engine_kw(), max_seq=LLAMA3_CHAT_SEQ)
    shifts, outs = [], {}
    for graphed in (True, False):
        gen = Generator(eng.params, cfg, cuda_graphs=graphed, **kw)
        real = gen.shift_context

        def shift(keep, discard, gen=gen, real=real):
            s = gen.max_seq
            start, m = keep + discard, gen.max_seq - keep - discard
            before = gen.kv.k[:, :, :, start:s].clone()
            real(keep, discard)
            ang = torch.from_numpy(-discard * inv).cuda()
            cos, sin = torch.cos(ang).float(), torch.sin(ang).float()
            k1, k2 = before.float().chunk(2, dim=-1)
            rec = torch.cat([k1 * cos - k2 * sin, k2 * cos + k1 * sin], dim=-1)
            err = float((gen.kv.k[:, :, :, keep:keep + m].float() - rec.to(gen.kv.k.dtype)
                         .float()).abs().max())
            scale = float(rec.abs().max())
            if err > 2.0 ** -7 * scale:
                raise AssertionError(f"llama3 chat shift: keys {err:.3e} off the recompute "
                                     f"(scale {scale:.3e})")
            shifts.append(dict(keep=keep, discard=discard, key_max_abs_err=err,
                               key_scale=scale))

        gen.shift_context = shift
        s = ChatSession(gen, eng.tokenizer, jinja_src=eng.metadata["tokenizer.chat_template"])
        outs[graphed] = []
        for text in texts:
            s.ask(text, max_new_tokens=LLAMA3_CHAT_NEW)
            outs[graphed].append(list(s.last_out))
        del gen.shift_context, gen
    if not shifts:
        raise AssertionError("llama3 chat: no context shift")
    if outs[True] != outs[False]:
        raise AssertionError("llama3 chat: graphed and eager sessions differ")
    sh = shifts[0]
    log(f"[llama3 chat] max_seq {LLAMA3_CHAT_SEQ}, llama3 template, 3 turns: {len(shifts) // 2} "
        f"shift(s) per session (keep {sh['keep']}, discard {sh['discard']}); the moved keys == "
        f"the factored formula's rotation within {max(x['key_max_abs_err'] for x in shifts):.2e} "
        f"(scale {sh['key_scale']:.2e}); graphed == eager bit for bit")
    return dict(shifts=shifts)


def nk_head_check(tag: str, head, cfg) -> dict:
    """A tied "nk" head (`ops/matmul.py:_qmatmul_nk`: the plain dequant and
    one product) at one decoded row against its f32 plain product, timed
    with its bound and library ms (`F.linear` on the table dequantized once
    to bf16)."""
    import torch
    import torch.nn.functional as F

    from eagle_tpu_torch.gguf import GGMLType
    from eagle_tpu_torch.ops.matmul import qmatmul

    x = torch.randn((1, cfg.n_embd), generator=torch.Generator(device="cuda").manual_seed(5),
                    device="cuda")
    got = qmatmul(x, head, torch.bfloat16)
    abs_err, rel = rel_err(got, x @ head.dequantize(torch.float32).T)
    if rel > QMM_TOL:
        raise AssertionError(f"{tag} head: rel err {rel:.3e}")
    ms = device_ms(lambda i: qmatmul(x, head, torch.bfloat16), 20)
    dense, xb = head.dequantize(torch.bfloat16), x.to(torch.bfloat16)
    lib = device_ms(lambda i: F.linear(xb, dense), 20)
    del dense
    torch.cuda.empty_cache()
    b_ms, b_by = bound_ms(nbytes(*head.tensors().values()) + x.numel() * 4 + got.numel() * 4,
                          2.0 * cfg.n_embd * cfg.vocab_size)
    log(f"[{tag}] the tied 'nk' head, 1 row, [{cfg.vocab_size} x {cfg.n_embd}] "
        f"{GGMLType(head.ggml_type).name}: dequant + product {ms:.4f} ms per token, bound "
        f"{b_ms * 1e3:.2f} us ({b_by}), library (F.linear on the dequantized bf16 table) "
        f"{lib:.4f} ms, rel err {rel:.2e}")
    return dict(name="nk head", n=cfg.vocab_size, k=cfg.n_embd, rows=1, ms=ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib, max_abs_err=abs_err, rel_err=rel)


def tied_cell(tmp: pathlib.Path, vocab: dict, text: str) -> tuple[dict, dict]:
    """A Llama-3.2-3B-Instruct-shape GGUF (d 3,072, 14 of its 28 layers, 24 heads over
    8 KV heads, n_ff 8,192, Q4_K layers, a tied Q6_K token_embd and no
    output.weight, rope factors at factor 32), minted, loaded through
    `Engine` and deleted: `greedy_cell` on the prompt (56 qmm_gemv per
    decoded token: the head is the plain "nk" product); the tied head
    alone against its f32 plain version, timed with its bound and library
    ms. Returns (the cell, the graphed run's launches)."""
    import gc

    import torch

    from eagle_tpu_torch.api import Engine, EngineConfig

    c = LLAMA3_3B
    t0 = time.time()
    path, _ = mint_gguf_pair(
        tmp, seed=53, d=c["d"], f=c["f"], v=c["v"], n_layers=c["n_layers"],
        n_heads=c["n_heads"], n_kv_heads=c["n_kv_heads"], tag="llama-3.2-3b-instruct",
        ctx=c["ctx"], rope_base=c["rope_base"], vocab=vocab, with_draft=False,
        layer_type="Q4_K", tied=True,
        rope_factors=llama3_factors(c["d"] // c["n_heads"], c["rope_base"], *LLAMA32_ROPE))
    out: dict = {"mint_s": time.time() - t0, "file_bytes": path.stat().st_size}
    t0 = time.time()
    eng = Engine(EngineConfig(model_path=path, max_seq=1024))
    torch.cuda.synchronize()
    out["load_s"] = time.time() - t0
    path.unlink()
    params, cfg = eng.params, eng.model_cfg
    head = params["output"]
    if head is not params["tok_embd"] or head.layout != "nk" or "rope_factors" not in params:
        raise AssertionError("llama3 tied: the head is not the tied 'nk' table")
    cell, launches = greedy_cell("llama3 tied", eng, eng.tokenizer.encode(text),
                                 {"qmm_gemv": TIED_GEMV})
    log(f"[llama3 tied] Llama-3.2-3B-shape tied Q6_K head ({out['file_bytes'] / 1e9:.3f} GB, "
        f"minted {out['mint_s']:.1f} s, Engine load {out['load_s']:.1f} s)")
    out.update(cell, head=nk_head_check("llama3 tied", head, cfg))
    del eng, params, head
    gc.collect()
    torch.cuda.empty_cache()
    return out, launches


def llama3_path(report: dict, tmp: pathlib.Path) -> dict:
    """Phase llama3: a Meta-Llama-3.1-8B-Instruct-shape Q4_K target (Q6_K
    head, rope factors, a 128,256-piece byte-level BPE vocabulary) and an
    EAGLE-LLaMA3-Instruct-8B-shape Q8_0 draft, minted into `tmp`, loaded
    through `Engine`; the kernels at the path's new shapes against their
    plain versions; `serve_cell` on a ~300-token prompt of BPE text (greedy
    and the EAGLE chain at C = 1 and 4, eager and graphed, 2 runs each: 65
    qmm_gemv per decoded token, 65 qmm_mma per verify cycle); the CLI and
    the server as subprocesses; a chat session that shifts; then the tied
    Llama-3.2-3B-shape file (`tied_cell`). Returns the launches of the 8B
    default path (greedy + EAGLE graphed at C = 1) and the tied graphed run,
    added."""
    import gc
    import shutil

    import numpy as np
    import torch

    from eagle_tpu_torch.api import Engine, EngineConfig
    from eagle_tpu_torch.tokenizer import BPETokenizer
    from eagle_tpu_torch.utils.args import build_parser, sampler_from_args

    if shutil.disk_usage(tmp).free < 7 * 2**30:
        raise RuntimeError("phase llama3 needs 7 GiB of disk")
    out: dict = {}
    c = LLAMA3_8B
    head_dim = c["d"] // c["n_heads"]
    factors = llama3_factors(head_dim, c["rope_base"], *LLAMA31_ROPE)
    t0 = time.time()
    vocab, words = llama3_vocab(seed=61)
    out["vocab_s"] = time.time() - t0
    t0 = time.time()
    target, draft_path = mint_gguf_pair(
        tmp, seed=67, d=c["d"], f=c["f"], v=c["v"], n_layers=c["n_layers"],
        n_heads=c["n_heads"], n_kv_heads=c["n_kv_heads"], tag="meta-llama-3.1-8b-instruct",
        ctx=c["ctx"], rope_base=c["rope_base"], vocab=vocab, layer_type="Q4_K",
        rope_factors=factors)
    out.update(mint_s=time.time() - t0, file_bytes={"target": target.stat().st_size,
                                                    "draft": draft_path.stat().st_size})
    greedy = sampler_from_args(build_parser("cli").parse_args(["-m", "-", "--temp", "0"]))
    t0 = time.time()
    eng = Engine(EngineConfig(model_path=target, draft_path=draft_path, max_seq=2048,
                              sampler=greedy))
    torch.cuda.synchronize()
    out["load_s"] = time.time() - t0
    params, draft, cfg, dcfg = eng.params, eng.draft_params, eng.model_cfg, eng.draft_cfg
    tok = eng.tokenizer
    if not isinstance(tok, BPETokenizer) or (cfg.n_kv_heads, dcfg.n_kv_heads) != (8, 8) or \
            not torch.equal(params["rope_factors"].cpu(), torch.from_numpy(factors)) or \
            params["output"].layout != "kn":
        raise AssertionError(f"llama3: the 8B file did not load as Llama-3.1: {cfg}")
    text = llama3_text(tok, words, LLAMA3_PROMPT_TOKENS, seed=71)
    ids = tok.encode(text)
    if ids[0] != 128000 or tok.decode(ids[1:]) != text:
        raise AssertionError("llama3: the prompt does not round-trip through the BPE tokenizer")
    log(f"[llama3] vocabulary of {len(vocab['tokenizer.ggml.tokens'])} pieces and "
        f"{len(vocab['tokenizer.ggml.merges'])} merges built in {out['vocab_s']:.1f} s; minted "
        f"{target.name} ({out['file_bytes']['target'] / 1e9:.3f} GB) and {draft_path.name} "
        f"({out['file_bytes']['draft'] / 1e9:.3f} GB) in {out['mint_s']:.1f} s; Engine load "
        f"{out['load_s']:.2f} s ({torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card); "
        f"the prompt: {len(ids)} tokens of BPE text ({len(text)} characters, multi-byte among "
        f"them), round trip exact")

    gen = torch.Generator(device="cuda").manual_seed(73)
    out["qmm"] = llama3_qmm_checks(params, draft, gen)
    out["ffn"] = llama3_ffn_checks(draft, gen)
    out["attention"] = gqa_flash_checks(gen, "llama3 kernel", c["n_heads"], c["n_kv_heads"])

    prompt = np.asarray(ids)
    want_tok = {"qmm_gemv": LLAMA3_GEMV, "ffn_out_norm": 0, "gate_up_act": 0, "qmm": 0}
    os.environ.pop("EAGLE_TPU_FUSED_FFN", None)
    cell = serve_cell("llama3", params, draft, cfg, dcfg, prompt, LLAMA3_NEW, want_tok,
                      LLAMA3_GEMV, fused=False)
    cell.pop("gen")
    out["cell"] = cell
    launches = dict(cell["variants"]["eagle graphed C=1"]["launches"])
    out["subprocesses"] = cli_server_subprocesses(target, draft_path, text, eng, tmp)
    out["chat"] = llama3_chat_shift(eng, words)
    del eng, params, draft
    gc.collect()
    torch.cuda.empty_cache()
    target.unlink()
    draft_path.unlink()
    out["tied"], tied_launches = tied_cell(tmp, vocab, text)
    for k, v in tied_launches.items():
        launches[k] = launches.get(k, 0) + v
    out["launches"] = launches
    report["llama3_path"] = out
    return launches


# --------------------------------------------------------------------------
# phase families: the Qwen2, Qwen3 and Gemma-2 families at their published shapes


#: the published configs (each model's config.json): Qwen2.5-7B-Instruct,
#: Qwen3-8B, Gemma-2-9B and Gemma-7B (google/gemma-7b: the query 16 x 256 =
#: 4,096 wide over n_embd 3,072). Qwen3-8B and Gemma-2-9B run at a third of
#: their published depth (12 of 36, 14 of 42 layers; widths whole) to keep the
#: script in its time budget
QWEN25_7B = dict(d=3584, f=18944, v=152064, n_layers=14, n_heads=28, n_kv_heads=4,
                 head_dim=128, ctx=32768, rope_base=1000000.0)
QWEN3_8B = dict(d=4096, f=12288, v=151936, n_layers=12, n_heads=32, n_kv_heads=8,
                head_dim=128, ctx=40960, rope_base=1000000.0)
GEMMA2_9B = dict(d=3584, f=14336, v=256000, n_layers=14, n_heads=16, n_kv_heads=8,
                 head_dim=256, ctx=8192, rope_base=10000.0)
GEMMA_7B = dict(d=3072, f=24576, v=256000, n_layers=14, n_heads=16, n_kv_heads=16,
                head_dim=256, ctx=8192, rope_base=10000.0)
GEMMA2_MD = {"gemma2.attn_logit_softcapping": 50.0, "gemma2.final_logit_softcapping": 30.0,
             "gemma2.attention.sliding_window": 4096,
             "gemma2.attention.query_pre_attn_scalar": 256}
#: Qwen2.5's named specials, from 151,643 (the rest of the table is [PAD] pieces)
QWEN_SPECIALS = ("<|endoftext|>", "<|im_start|>", "<|im_end|>", "<|object_ref_start|>",
                 "<|object_ref_end|>", "<|box_start|>", "<|box_end|>", "<|quad_start|>",
                 "<|quad_end|>", "<|vision_start|>", "<|vision_end|>", "<|vision_pad|>",
                 "<|image_pad|>", "<|video_pad|>", "<tool_call>", "</tool_call>",
                 "<|fim_prefix|>", "<|fim_middle|>", "<|fim_suffix|>", "<|fim_pad|>",
                 "<|repo_name|>", "<|file_sep|>")
QWEN_PIECES = 151643
CHATML_TEMPLATE = ("{% for message in messages %}{{'<|im_start|>' + message['role'] + '\\n' + "
                   "message['content'] + '<|im_end|>' + '\\n'}}{% endfor %}{% if "
                   "add_generation_prompt %}{{ '<|im_start|>assistant\\n' }}{% endif %}")
GEMMA_TEMPLATE = ("{{ bos_token }}{% for message in messages %}{{ '<start_of_turn>' + "
                  "message['role'] + '\\n' + message['content'] | trim + '<end_of_turn>\\n' }}"
                  "{% endfor %}{% if add_generation_prompt %}{{'<start_of_turn>model\\n'}}"
                  "{% endif %}")
FAMILY_NEW = 64  # new tokens of a `greedy_cell` and of the `families` serve cell
FAMILY_PROMPT_TOKENS = 300
#: launches per decoded token: 4 stacked products a layer + lm_head; a
#: flash_decode a layer; Gemma-2's tied head and softcapped attention take none
QWEN25_GEMV, QWEN25_FLASH = QWEN25_7B["n_layers"] * 4 + 1, QWEN25_7B["n_layers"]
QWEN3_GEMV, QWEN3_FLASH = QWEN3_8B["n_layers"] * 4 + 1, QWEN3_8B["n_layers"]
GEMMA2_GEMV = GEMMA2_9B["n_layers"] * 4
GEMMA7_GEMV, GEMMA7_FLASH = GEMMA_7B["n_layers"] * 4, GEMMA_7B["n_layers"]  # tied: no qmm


def qwen_vocab(seed: int, v: int) -> tuple[dict, list]:
    """A Qwen2-layout byte-level BPE vocabulary of `v` entries as GGUF
    metadata, and its words: `bpe_vocab` with 151,643 pieces, Qwen2.5's 22
    named specials and pre "qwen2"; EOS <|im_end|> (the Instruct files'), a
    chatml template."""
    md, words = bpe_vocab(seed, v, QWEN_PIECES, QWEN_SPECIALS, "qwen2")
    md.update({"tokenizer.ggml.eos_token_id": QWEN_PIECES + 2,
               "tokenizer.ggml.padding_token_id": QWEN_PIECES,
               "tokenizer.chat_template": CHATML_TEMPLATE})
    return md, words


def family_load(tag: str, c: dict, tmp: pathlib.Path, seed: int, vocab: dict, arch: str,
                with_draft: bool, metadata: dict | None = None, tied: bool = False,
                phase: str = "families", check=None, **mint):
    """Mint a `c`-shape `arch` target (Q4_K layers, a Q6_K head or tied
    table; `mint`: more of `mint_gguf_pair`'s arguments) and, `with_draft`,
    an EAGLE Q8_0 draft of its widths; load them through `Engine` (greedy,
    max_seq 2,048), call `check(eng, target)` where given, and delete the
    files. Returns (Engine, the record: mint and load seconds, file bytes,
    the card's memory after the load and its peak during it)."""
    import torch

    from eagle_tpu_torch.api import Engine, EngineConfig
    from eagle_tpu_torch.utils.args import build_parser, sampler_from_args

    t0 = time.time()
    target, draft = mint_gguf_pair(
        tmp, seed=seed, d=c["d"], f=c["f"], v=c["v"], n_layers=c["n_layers"],
        n_heads=c["n_heads"], n_kv_heads=c["n_kv_heads"], head_dim=c["head_dim"], tag=tag,
        ctx=c["ctx"], rope_base=c["rope_base"], vocab=vocab, metadata=metadata,
        with_draft=with_draft, layer_type="Q4_K", arch=arch, tied=tied, **mint)
    rec = {"mint_s": time.time() - t0, "target_bytes": target.stat().st_size,
           "draft_bytes": draft.stat().st_size if draft else 0}
    greedy = sampler_from_args(build_parser("cli").parse_args(["-m", "-", "--temp", "0"]))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    eng = Engine(EngineConfig(model_path=target, draft_path=draft, max_seq=2048, sampler=greedy))
    torch.cuda.synchronize()
    rec["load_s"] = time.time() - t0
    rec["device_gib"] = torch.cuda.memory_allocated() / 2**30
    rec["device_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    if check is not None:
        rec["check"] = check(eng, target)
    target.unlink()
    if draft:
        draft.unlink()
    cfg = eng.model_cfg
    if (cfg.arch, cfg.n_layers, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim) != (
            arch, c["n_layers"], c["n_heads"], c["n_kv_heads"], c["head_dim"]):
        raise AssertionError(f"{tag}: the file loaded as {cfg}")
    log(f"[{phase}] {tag}: minted {rec['target_bytes'] / 1e9:.3f} GB"
        + (f" + a {rec['draft_bytes'] / 1e9:.3f} GB EAGLE draft" if draft else "")
        + f" in {rec['mint_s']:.1f} s; Engine load {rec['load_s']:.2f} s "
        f"({rec['device_gib']:.2f} GiB on the card, {rec['device_peak_gib']:.2f} at the "
        f"load's peak)")
    return eng, rec


def family_kernels(tag: str, params, gen, rows_list, draft=None,
                   log_tag: str = "families kernel") -> dict:
    """qmm at the target's shapes (and the draft's fc) on each route of
    `rows_list` ((rows, route, what)), against the plain version, timed."""
    rows_out, totals = [], {}
    specs = [(f"{tag} {name}", w, n) for name, w, n in target_qmm_specs(params)]
    for rows, route, what in rows_list:
        totals[what] = qmm_sum(log_tag, f"{tag} {what}", rows, specs, route, gen, rows_out)
        if draft is not None:
            qmm_sum(log_tag, f"{tag} draft fc at {rows} rows", rows,
                    [(f"{tag} draft fc", draft["fc_w"], 1)], route, gen, rows_out)
    return dict(rows=rows_out, totals=totals)


def greedy_cell(tag: str, eng, ids: list, want_tok: dict) -> tuple[dict, dict]:
    """Greedy `Generator` (max_seq 1,024, FAMILY_NEW new tokens) on the
    prompt's ids: eager once,
    graphed once to capture, then REPS timed graphed runs, every run's
    tokens bit for bit the eager run's, no eager body after the capture, no
    plain version; launches per decoded token == `want_tok` (keys absent
    from it: any). TTFT, t/s, device ms per token (CUDA events over 16
    replays) and the idle share. Returns (the cell, the first timed run's
    launches)."""
    from eagle_tpu_torch import _build
    from eagle_tpu_torch.runtime.generate import Generator

    gen = Generator(eng.params, eng.model_cfg, max_seq=1024, eos_id=-1)

    def run(on_token):
        return gen.generate(ids, max_new_tokens=FAMILY_NEW, stop_at_eos=False,
                            on_token=on_token)

    want = eager_tokens(gen, lambda: run(None))
    if run(None) != want:  # the captures
        raise AssertionError(f"{tag}: graphed tokens differ from eager")
    eager = gen.graphs.eager
    res: dict = {"ttft_ms": [], "tokens_per_s": [], "wall_ms_per_token": []}
    launches: dict = {}
    for rep in range(REPS):
        _build.reset_counts()
        toks, ttft, after, at_first, _ = timed_run(run)
        per_tok = {k: (_build.launches[k] - at_first[k]) / (FAMILY_NEW - 1)
                   for k in _build.launches}
        if toks != want or gen.graphs.eager != eager:
            raise AssertionError(f"{tag} run {rep}: tokens differ from eager, or a step ran "
                                 "eagerly")
        if any(per_tok[k] != v for k, v in want_tok.items()) or any(_build.plain_calls.values()):
            raise AssertionError(f"{tag}: launches per decoded token {per_tok} (expected "
                                 f"{want_tok}), plain {_build.plain_calls}")
        if rep == 0:
            launches = {k: v for k, v in _build.launches.items() if v}
            res.update(launches_per_decoded_token=per_tok, launches_at_first_token=at_first)
        res["ttft_ms"].append(ttft * 1e3)
        res["tokens_per_s"].append((FAMILY_NEW - 1) / after)
        res["wall_ms_per_token"].append(after / (FAMILY_NEW - 1) * 1e3)
    for key in ("ttft_ms", "tokens_per_s", "wall_ms_per_token"):
        res[key] = spread(res[key])
    res["device_ms_per_token"] = decode_device_ms(gen, ids)
    res["idle_share"] = 1 - res["device_ms_per_token"] / res["wall_ms_per_token"]["median"]
    res["tokens"] = want
    log(f"[{tag}] greedy, {len(ids)}-token prompt, {FAMILY_NEW} new: graphed == eager bit for "
        f"bit ({REPS} runs), launches per decoded token "
        + ", ".join(f"{k} {res['launches_per_decoded_token'][k]:.0f}" for k in want_tok)
        + f"; tokens/s min / median / max {fmt(res['tokens_per_s'])}, TTFT ms "
        f"{fmt(res['ttft_ms'], 1)}, device {res['device_ms_per_token']:.3f} ms per token, idle "
        f"{100 * res['idle_share']:.1f}%")
    return res, launches


def qwen25_cell(tmp: pathlib.Path, gen) -> tuple[dict, dict]:
    """Qwen2.5-7B-Instruct's shape (q/k/v biases, 28 query heads over 4 KV
    heads: g = 7) with a 152,064-entry BPE vocabulary ("qwen2"
    pre-tokenizer, chatml) and an EAGLE-Qwen2-7B-Instruct-shape Q8_0 draft;
    qmm at the path's shapes at 1, 6 and 300 rows and both flash kernels at
    g = 7; `serve_cell` (greedy and the chain at C = 1 and 4, eager and
    graphed, 2 runs each): 57 qmm_gemv and 14 flash_decode per decoded
    token, 57 qmm_mma per verify. Returns (the cell, the default path's
    launches)."""
    import numpy as np

    from eagle_tpu_torch.server.chat_templates import detect_template
    from eagle_tpu_torch.tokenizer import BPETokenizer

    c = QWEN25_7B
    t0 = time.time()
    vocab, words = qwen_vocab(seed=89, v=c["v"])
    out: dict = {"vocab_s": time.time() - t0}
    eng, out["files"] = family_load("qwen2.5-7b-instruct", c, tmp, 97, vocab, "qwen2",
                                    with_draft=True)
    params, draft, cfg, dcfg = eng.params, eng.draft_params, eng.model_cfg, eng.draft_cfg
    tok = eng.tokenizer
    if (not isinstance(tok, BPETokenizer) or "bqkv" not in params["layers"]
            or not cfg.attn_bias or detect_template(eng.metadata["tokenizer.chat_template"])
            != "chatml" or (dcfg.arch, dcfg.n_kv_heads) != ("eagle", 4)):
        raise AssertionError(f"qwen2.5: the files did not load as Qwen2.5 + EAGLE: {cfg}")
    text = llama3_text(tok, words, FAMILY_PROMPT_TOKENS, seed=101)
    ids = tok.encode(text)
    if tok.decode(ids) != text:
        raise AssertionError("qwen2.5: the prompt does not round-trip through the tokenizer")
    out["prompt_tokens"] = len(ids)
    out["qmm"] = family_kernels("qwen2.5", params, gen, (
        (1, "qmm_gemv", "decoded token"), (VERIFY_ROWS, "qmm_mma", "verify cycle"),
        (FAMILY_PROMPT_TOKENS, "qmm_tc", "300-row prompt")), draft=draft)
    out["attention"] = gqa_flash_checks(gen, "families kernel", c["n_heads"], c["n_kv_heads"])
    want_tok = {"qmm_gemv": QWEN25_GEMV, "flash_decode": QWEN25_FLASH, "ffn_out_norm": 0,
                "gate_up_act": 0, "qmm": 0}
    os.environ.pop("EAGLE_TPU_FUSED_FFN", None)
    cell = serve_cell("qwen2.5", params, draft, cfg, dcfg, np.asarray(ids), FAMILY_NEW,
                      want_tok, QWEN25_GEMV, fused=False)
    cell.pop("gen")
    out["cell"] = cell
    return out, dict(cell["variants"]["eagle graphed C=1"]["launches"])


def qwen3_cell(tmp: pathlib.Path, gen) -> tuple[dict, dict]:
    """Qwen3-8B's shape (per-head q/k norms; 32 over 8 KV heads of 128: the
    flash kernels' shapes of phase llama3) with a 151,936-entry vocabulary:
    qmm at 1 and 300 rows, then `greedy_cell` (4 qmm_gemv a layer + 1 and a
    flash_decode a layer per decoded token)."""
    c = QWEN3_8B
    vocab, words = qwen_vocab(seed=103, v=c["v"])
    eng, files = family_load("qwen3-8b", c, tmp, 107, vocab, "qwen3", with_draft=False)
    if "attn_q_norm" not in eng.params["layers"]:
        raise AssertionError("qwen3: no q/k norms loaded")
    ids = eng.tokenizer.encode(llama3_text(eng.tokenizer, words, FAMILY_PROMPT_TOKENS, seed=109))
    out = {"files": files, "prompt_tokens": len(ids)}
    out["qmm"] = family_kernels("qwen3", eng.params, gen, (
        (1, "qmm_gemv", "decoded token"), (FAMILY_PROMPT_TOKENS, "qmm_tc", "300-row prompt")))
    out["cell"], launches = greedy_cell("qwen3", eng, ids, {
        "qmm_gemv": QWEN3_GEMV, "flash_decode": QWEN3_FLASH, "qmm": 0})
    return out, launches


def plain_attention_checks(gen, cfg, tag: str) -> list:
    """A model's attention on the plain `gqa_attention` (no kernel in either
    package: a softcap, or a head width the flash kernels do not take), at
    its heads, bf16 cache: one decoded row over 512 and 1,024 slots (364
    visible) and a 512-row prompt (300 real rows); its ms per call against
    the bound (K and V of the visible slots once; the score and value
    products at the bf16 rate) and, without a softcap, SDPA's on the same
    inputs (`enable_gqa`)."""
    import torch
    import torch.nn.functional as F

    from eagle_tpu_torch.ops.attention import gqa_attention
    from eagle_tpu_torch.runtime.kvcache import causal_mask_from_tags

    h, h_kv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    out = []
    for t, s, n in ((1, 512, 364), (1, 1024, 364), (512, 512, 300)):
        kc = torch.randn((1, h_kv, s, d), generator=gen, device="cuda").to(torch.bfloat16)
        vc = torch.randn((1, h_kv, s, d), generator=gen, device="cuda").to(torch.bfloat16)
        tags = torch.full((1, s), -1, dtype=torch.int32, device="cuda")
        tags[:, :n] = torch.arange(n, dtype=torch.int32, device="cuda")
        pos = (torch.arange(t, dtype=torch.int32, device="cuda") + (n - 1 if t == 1 else 0))[None]
        mask = causal_mask_from_tags(tags, pos)
        q = torch.randn((1, t, h, d), generator=gen, device="cuda")
        run = lambda i: gqa_attention(q, kc, vc, mask, scale=cfg.attn_scale,  # noqa: E731
                                      softcap=cfg.attn_softcap)
        got = run(0)
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{tag} attention T={t}: non-finite output")
        ms = device_ms(run, 20)
        lib = None
        if cfg.attn_softcap == 0:
            qb = q.transpose(1, 2).to(torch.bfloat16)
            lib = device_ms(lambda i: F.scaled_dot_product_attention(
                qb, kc, vc, attn_mask=mask[:, None], scale=cfg.attn_scale,
                enable_gqa=h != h_kv), 20)
        pairs = int(mask.sum())
        b_ms, b_by = bound_ms(2 * n * h_kv * d * 2 + nbytes(q, mask) + q.numel() * 4,
                              4.0 * pairs * h * d)
        out.append(dict(name="gqa_attention (plain)", t=t, s=s, visible=n, ms=ms,
                        bound_ms=b_ms, bound_by=b_by, library_ms=lib,
                        per_token_ms=ms * cfg.n_layers if t == 1 else None))
        log(f"[{tag}] plain attention T={t} S={s} ({n} visible) H={h}/{h_kv} D={d} "
            f"softcap {cfg.attn_softcap:g}: {ms:.4f} ms per call"
            + (f" ({ms * cfg.n_layers:.3f} ms per token over {cfg.n_layers} layers)"
               if t == 1 else "")
            + f", bound {b_ms * 1e3:.2f} us ({b_by}), library "
            + (f"{lib:.4f} ms (SDPA)" if lib is not None else "none (no call takes the softcap)"))
        del kc, vc
    torch.cuda.empty_cache()
    return out


def gemma2_cell(tmp: pathlib.Path, gen) -> tuple[dict, dict]:
    """Gemma-2-9B's shape (GEMMA2_9B's layers, 16 over 8 KV heads of 256, sandwich
    norms, GELU, softcaps 50 / 30, a 4,096-slot window on even layers,
    query_pre_attn_scalar 256, a tied Q6_K table of 256,000 SPM pieces, a
    gemma template): qmm at 1 and 300 rows, the plain attention and the
    tied head timed, then `greedy_cell` (4 qmm_gemv a layer per decoded
    token, no flash kernel at all)."""
    from eagle_tpu_torch.server.chat_templates import detect_template

    c = GEMMA2_9B
    vocab = {**spm_vocab(c["v"], seed=113), "tokenizer.chat_template": GEMMA_TEMPLATE}
    eng, files = family_load("gemma-2-9b", c, tmp, 127, vocab, "gemma2", with_draft=False,
                             metadata=GEMMA2_MD, tied=True)
    cfg, params = eng.model_cfg, eng.params
    if ((cfg.attn_softcap, cfg.final_softcap, cfg.swa_window, cfg.swa_every, cfg.act)
            != (50.0, 30.0, 4096, 2, "gelu") or params["output"] is not params["tok_embd"]
            or "post_ffn_norm" not in params["layers"]
            or detect_template(eng.metadata["tokenizer.chat_template"]) != "gemma"):
        raise AssertionError(f"gemma2: the file did not load as Gemma-2: {cfg}")
    ids = eng.tokenizer.encode(cli_prompt(vocab["tokenizer.ggml.tokens"], FAMILY_PROMPT_TOKENS,
                                          seed=131))
    out = {"files": files, "prompt_tokens": len(ids)}
    out["qmm"] = family_kernels("gemma2", params, gen, (
        (1, "qmm_gemv", "decoded token"), (FAMILY_PROMPT_TOKENS, "qmm_tc", "300-row prompt")))
    out["attention"] = plain_attention_checks(gen, cfg, "families kernel")
    out["head"] = nk_head_check("families kernel", params["output"], cfg)
    out["cell"], launches = greedy_cell("gemma2", eng, ids, {
        "qmm_gemv": GEMMA2_GEMV, "flash_decode": 0, "flash_prefill": 0, "qmm": 0})
    if launches.get("flash_prefill") or launches.get("flash_decode"):
        raise AssertionError(f"gemma2: a flash kernel ran: {launches}")
    return out, launches


def gemma_cell(tmp: pathlib.Path, gen) -> tuple[dict, dict]:
    """Gemma-7B's shape (14 of its 28 layers, 16 / 16 heads of 256 over n_embd
    3,072, n_ff 24,576, GELU, the sqrt(n_embd) embedding scale, no softcap
    or window: its attention on the flash kernels at D = 256) with a tied
    Q6_K table of 256,000 SPM pieces and a gemma template, and an EAGLE
    Q8_0 draft minted at the target's widths: qmm at the path's shapes
    (wqkv N 12,288, wo K 4,096, w_gate_up N 49,152, w_down K 24,576) at 1,
    6 and 300 rows and the draft's fc, the tied "nk" head timed (the draft
    borrows it: 6 calls a chain cycle); `serve_cell` (greedy and the chain
    at C = 1 and 4, eager and graphed, 2 runs each): 56 qmm_gemv and 14
    flash_decode per decoded token, 56 qmm_mma per verify, 14
    flash_prefill per greedy prompt. Returns (the cell, the default path's
    launches)."""
    import numpy as np

    from eagle_tpu_torch.server.chat_templates import detect_template

    c = GEMMA_7B
    vocab = {**spm_vocab(c["v"], seed=137), "tokenizer.chat_template": GEMMA_TEMPLATE}
    eng, files = family_load("gemma-7b", c, tmp, 139, vocab, "gemma", with_draft=True,
                             tied=True)
    params, draft, cfg, dcfg = eng.params, eng.draft_params, eng.model_cfg, eng.draft_cfg
    if ((cfg.act, cfg.embd_scale, cfg.attn_softcap, cfg.swa_window, cfg.post_norms)
            != ("gelu", c["d"] ** 0.5, 0.0, 0, False) or cfg.n_q_dim != 4096
            or params["output"] is not params["tok_embd"]
            or detect_template(eng.metadata["tokenizer.chat_template"]) != "gemma"
            or (dcfg.arch, dcfg.n_heads, dcfg.head_dim) != ("eagle", 16, 256)):
        raise AssertionError(f"gemma: the files did not load as Gemma-7B + EAGLE: {cfg}, "
                             f"{dcfg}")
    ids = eng.tokenizer.encode(cli_prompt(vocab["tokenizer.ggml.tokens"], FAMILY_PROMPT_TOKENS,
                                          seed=149))
    out = {"files": files, "prompt_tokens": len(ids)}
    out["qmm"] = family_kernels("gemma", params, gen, (
        (1, "qmm_gemv", "decoded token"), (VERIFY_ROWS, "qmm_mma", "verify cycle"),
        (FAMILY_PROMPT_TOKENS, "qmm_tc", "300-row prompt")), draft=draft)
    out["head"] = nk_head_check("families kernel", params["output"], cfg)
    want_tok = {"qmm_gemv": GEMMA7_GEMV, "flash_decode": GEMMA7_FLASH, "ffn_out_norm": 0,
                "gate_up_act": 0, "qmm": 0, "flash_decode_mma_cluster": GEMMA7_FLASH}
    os.environ.pop("EAGLE_TPU_FUSED_FFN", None)
    cell = serve_cell("gemma", params, draft, cfg, dcfg, np.asarray(ids), FAMILY_NEW,
                      want_tok, GEMMA7_GEMV, fused=False)
    cell.pop("gen")
    prompt = cell["variants"]["greedy graphed"]["launches_at_first_token"]
    if prompt["flash_prefill"] != GEMMA7_FLASH or prompt["flash_decode"]:
        raise AssertionError(f"gemma: the greedy prompt's attention launches {prompt}, "
                             f"expected {GEMMA7_FLASH} flash_prefill")
    # flash_decode's D = 256 routes on the default path (greedy + EAGLE at C =
    # 1): the cluster body for decode, verify and draft steps, the wgmma body
    # for the EAGLE prompt (the target's layers and the draft's one)
    main = cell["variants"]["eagle graphed C=1"]["launches"]
    routes = {k: main[f"flash_decode_{k}"] for k in ("mma_cluster", "wgmma")}
    if routes["wgmma"] != GEMMA7_FLASH + 1 or routes["mma_cluster"] + routes["wgmma"] != \
            main["flash_decode"]:
        raise AssertionError(f"gemma: flash_decode's routes on the default path {routes} of "
                             f"{main['flash_decode']} launches; expected {GEMMA7_FLASH + 1} "
                             f"wgmma (the EAGLE prompt) and the rest mma_cluster")
    log(f"[gemma] the greedy prompt: {prompt['flash_prefill']} flash_prefill, "
        f"{prompt['qmm_tc']} qmm_tc; flash_decode on the default path: "
        f"{routes['mma_cluster']} mma_cluster (decode, verify, draft steps), {routes['wgmma']} "
        f"wgmma (the EAGLE prompt); EAGLE == greedy: "
        f"{cell['eagle_tokens'] == cell['greedy_tokens']}")
    out["cell"] = cell
    return out, dict(cell["variants"]["eagle graphed C=1"]["launches"])


def families_path(report: dict, tmp: pathlib.Path) -> dict:
    """Phase families: the Qwen2.5-7B-Instruct (+ EAGLE), Qwen3-8B,
    Gemma-2-9B and Gemma-7B (+ EAGLE) cells, each minted into `tmp`, loaded
    through `Engine`, its kernels checked at its shapes, run, and freed
    before the next. Returns the launches of the Qwen2.5 and Gemma-7B
    default paths (greedy + EAGLE graphed at C = 1) and of the first timed
    graphed run of the other two, added."""
    import gc
    import shutil

    import torch

    if shutil.disk_usage(tmp).free < 7 * 2**30:
        raise RuntimeError("phase families needs 7 GiB of disk")
    gen = torch.Generator(device="cuda").manual_seed(83)
    out: dict = {}
    launches: dict = {}
    for name, cell in (("qwen2.5", qwen25_cell), ("qwen3", qwen3_cell),
                       ("gemma2", gemma2_cell), ("gemma", gemma_cell)):
        t0 = time.time()
        out[name], part = cell(tmp, gen)
        gc.collect()
        torch.cuda.empty_cache()
        out[name]["seconds"] = time.time() - t0
        log(f"[time] families {name}: {out[name]['seconds']:.1f} s")
        for k, v in part.items():
            launches[k] = launches.get(k, 0) + v
    out["launches"] = launches
    report["families_path"] = out
    return launches


# --------------------------------------------------------------------------
# phase layernorm: the rotary LayerNorm families at their published shapes


#: the published configs (config.json): bigcode/starcoder2-7b (its
#: sliding_window of 4,096 does not bite at max_seq 1,024 and llama.cpp's
#: files carry none) and microsoft/phi-2 (partial_rotary_factor 0.4), at
#: 16 of their 32 layers to fit the script's time
STARCODER2_7B = dict(d=4608, f=18432, v=49152, n_layers=16, n_heads=36, n_kv_heads=4,
                     head_dim=128, ctx=16384, rope_base=1000000.0)
PHI2 = dict(d=2560, f=10240, v=51200, n_layers=16, n_heads=32, n_kv_heads=32, head_dim=80,
            ctx=2048, rope_base=10000.0, rope_dim=32)
#: launches per decoded token: wqkv, wo, w_up, w_down a layer + lm_head
STARCODER2_GEMV = STARCODER2_7B["n_layers"] * 4 + 1
STARCODER2_FLASH = STARCODER2_7B["n_layers"]
PHI2_GEMV = PHI2["n_layers"] * 4 + 1
#: the vocabularies' specials: StarCoder2's (its first 38 ids in the
#: published file; here at the end of the minted pieces) and GPT-2's
STARCODER2_SPECIALS = ("<|endoftext|>", "<fim_prefix>", "<fim_middle>", "<fim_suffix>",
                       "<fim_pad>", "<repo_name>", "<file_sep>", "<issue_start>",
                       "<issue_comment>", "<issue_closed>", "<jupyter_start>",
                       "<jupyter_text>", "<jupyter_code>", "<jupyter_output>",
                       "<jupyter_script>", "<empty_output>", "<code_to_intermediate>",
                       "<intermediate_to_code>", "<pr>", "<pr_status>", "<pr_is_merged>",
                       "<pr_base>", "<pr_file>", "<pr_base_code>", "<pr_diff>",
                       "<pr_diff_hunk>", "<pr_comment>", "<pr_event_id>", "<pr_review>",
                       "<pr_review_state>", "<pr_review_comment>", "<pr_in_reply_to>",
                       "<pr_in_reply_to_review_id>", "<pr_diff_hunk_comment_line>",
                       "<NAME>", "<EMAIL>", "<KEY>", "<PASSWORD>")


def starcoder2_cell(tmp: pathlib.Path, gen) -> tuple[dict, dict]:
    """StarCoder2-7B's shape at 16 of its 32 layers (LayerNorm with biases,
    q/k/v and output biases, a no-gate GELU MLP with biases, 36 query over
    4 KV heads of 128: g = 9) with a 49,152-entry BPE vocabulary ("starcoder" pre-tokenizer) and an
    EAGLE Q8_0 draft at its widths; qmm at the path's shapes at 1, 6 and 300
    rows and the draft's fc, both flash kernels at g = 9; `serve_cell`
    (greedy and the chain at C = 1 and 4, eager and graphed, 2 runs each):
    65 qmm_gemv and 16 flash_decode per decoded token, 65 qmm_mma per
    verify, 16 flash_prefill per greedy prompt. Returns (the cell, the
    default path's launches)."""
    import numpy as np

    from eagle_tpu_torch.tokenizer import BPETokenizer

    c = STARCODER2_7B
    t0 = time.time()
    vocab, words = bpe_vocab(157, c["v"], c["v"] - len(STARCODER2_SPECIALS), STARCODER2_SPECIALS,
                            "starcoder")
    out: dict = {"vocab_s": time.time() - t0}
    eng, out["files"] = family_load("starcoder2-7b", c, tmp, 163, vocab, "starcoder2",
                                    with_draft=True, phase="layernorm")
    params, draft, cfg, dcfg = eng.params, eng.draft_params, eng.model_cfg, eng.draft_cfg
    tok = eng.tokenizer
    layers = params["layers"]
    if (not isinstance(tok, BPETokenizer) or cfg.norm_type != "layer" or cfg.parallel_blocks
            or cfg.act != "gelu" or cfg.rope_dim != cfg.head_dim or "w_gate_up" in layers
            or not {"bqkv", "bo", "b_up", "b_down", "attn_norm_b", "ffn_norm_b"} <= set(layers)
            or "output_norm_b" not in params or (dcfg.arch, dcfg.n_kv_heads) != ("eagle", 4)):
        raise AssertionError(f"starcoder2: the files did not load as StarCoder2 + EAGLE: {cfg}")
    text = llama3_text(tok, words, FAMILY_PROMPT_TOKENS, seed=167)
    ids = tok.encode(text)
    if tok.decode(ids) != text:
        raise AssertionError("starcoder2: the prompt does not round-trip through the tokenizer")
    out["prompt_tokens"] = len(ids)
    out["qmm"] = family_kernels("starcoder2", params, gen, (
        (1, "qmm_gemv", "decoded token"), (VERIFY_ROWS, "qmm_mma", "verify cycle"),
        (FAMILY_PROMPT_TOKENS, "qmm_tc", "300-row prompt")), draft=draft,
        log_tag="layernorm kernel")
    out["attention"] = gqa_flash_checks(gen, "layernorm kernel", c["n_heads"], c["n_kv_heads"])
    want_tok = {"qmm_gemv": STARCODER2_GEMV, "flash_decode": STARCODER2_FLASH,
                "ffn_out_norm": 0, "gate_up_act": 0, "qmm": 0}
    os.environ.pop("EAGLE_TPU_FUSED_FFN", None)
    cell = serve_cell("starcoder2", params, draft, cfg, dcfg, np.asarray(ids), FAMILY_NEW,
                      want_tok, STARCODER2_GEMV, fused=False)
    cell.pop("gen")
    prompt = cell["variants"]["greedy graphed"]["launches_at_first_token"]
    if prompt["flash_prefill"] != STARCODER2_FLASH or prompt["flash_decode"]:
        raise AssertionError(f"starcoder2: the greedy prompt's attention launches {prompt}, "
                             f"expected {STARCODER2_FLASH} flash_prefill")
    log(f"[starcoder2] the greedy prompt: {prompt['flash_prefill']} flash_prefill, "
        f"{prompt['qmm_tc']} qmm_tc; EAGLE == greedy: "
        f"{cell['eagle_tokens'] == cell['greedy_tokens']}")
    out["cell"] = cell
    return out, dict(cell["variants"]["eagle graphed C=1"]["launches"])


def phi2_cell(tmp: pathlib.Path, gen) -> tuple[dict, dict]:
    """Phi-2's shape (32 heads of 80: the plain attention; 32 of 80 features
    rotary; one shared LayerNorm feeding attention and a no-gate GELU MLP in
    parallel; biases on q/k/v, dense, fc1 / fc2 and the head) with a
    51,200-entry BPE vocabulary ("phi-2" pre-tokenizer): qmm at 1 and 300
    rows, the plain attention timed, `greedy_cell` (65 qmm_gemv per decoded
    token, no flash kernel), then the CLI and the server as subprocesses on
    the file, each == the in-process Engine's text; the file is deleted
    after them."""
    import torch

    from eagle_tpu_torch.api import Engine, EngineConfig
    from eagle_tpu_torch.utils.args import build_parser, sampler_from_args

    c = PHI2
    vocab, words = bpe_vocab(173, c["v"], 50256, ("<|endoftext|>",), "phi-2")
    t0 = time.time()
    target, _ = mint_gguf_pair(
        tmp, seed=179, d=c["d"], f=c["f"], v=c["v"], n_layers=c["n_layers"],
        n_heads=c["n_heads"], n_kv_heads=c["n_kv_heads"], head_dim=c["head_dim"], tag="phi-2",
        ctx=c["ctx"], rope_base=c["rope_base"], vocab=vocab, with_draft=False,
        layer_type="Q4_K", arch="phi2", rope_dim=c["rope_dim"])
    files = {"mint_s": time.time() - t0, "target_bytes": target.stat().st_size}
    greedy = sampler_from_args(build_parser("cli").parse_args(["-m", "-", "--temp", "0"]))
    t0 = time.time()
    eng = Engine(EngineConfig(model_path=target, max_seq=2048, sampler=greedy))
    torch.cuda.synchronize()
    files["load_s"] = time.time() - t0
    cfg, params = eng.model_cfg, eng.params
    layers = params["layers"]
    if ((cfg.arch, cfg.norm_type, cfg.parallel_blocks, cfg.rope_dim, cfg.head_dim, cfg.act)
            != ("phi2", "layer", True, 32, 80, "gelu") or "ffn_norm" in layers
            or "w_gate_up" in layers or "output_b" not in params
            or not {"bqkv", "bo", "b_up", "b_down", "attn_norm_b"} <= set(layers)):
        raise AssertionError(f"phi2: the file did not load as Phi-2: {cfg}")
    log(f"[layernorm] phi-2: minted {files['target_bytes'] / 1e9:.3f} GB in "
        f"{files['mint_s']:.1f} s; Engine load {files['load_s']:.2f} s")
    text = llama3_text(eng.tokenizer, words, FAMILY_PROMPT_TOKENS, seed=181)
    ids = eng.tokenizer.encode(text)
    out = {"files": files, "prompt_tokens": len(ids)}
    out["qmm"] = family_kernels("phi2", params, gen, (
        (1, "qmm_gemv", "decoded token"), (FAMILY_PROMPT_TOKENS, "qmm_tc", "300-row prompt")),
        log_tag="layernorm kernel")
    out["attention"] = plain_attention_checks(gen, cfg, "layernorm kernel")
    out["cell"], launches = greedy_cell("phi2", eng, ids, {
        "qmm_gemv": PHI2_GEMV, "flash_decode": 0, "flash_prefill": 0, "qmm": 0})
    if launches.get("flash_prefill") or launches.get("flash_decode"):
        raise AssertionError(f"phi2: a flash kernel ran: {launches}")
    out["subprocesses"] = cli_server_subprocesses(target, None, text, eng, tmp, tag="phi2",
                                                  template="chatml")
    target.unlink()
    return out, launches


def layernorm_path(report: dict, tmp: pathlib.Path) -> dict:
    """Phase layernorm: the StarCoder2-7B (+ EAGLE) and Phi-2 cells, each
    minted into `tmp`, loaded through `Engine`, its kernels checked at its
    shapes, run, and freed before the next. Returns the launches of the
    StarCoder2 default path (greedy + EAGLE graphed at C = 1) and of the
    Phi-2 cell's first timed graphed run, added."""
    import gc
    import shutil

    import torch

    if shutil.disk_usage(tmp).free < 6 * 2**30:
        raise RuntimeError("phase layernorm needs 6 GiB of disk")
    gen = torch.Generator(device="cuda").manual_seed(151)
    out: dict = {}
    launches: dict = {}
    for name, cell in (("starcoder2", starcoder2_cell), ("phi2", phi2_cell)):
        t0 = time.time()
        out[name], part = cell(tmp, gen)
        gc.collect()
        torch.cuda.empty_cache()
        out[name]["seconds"] = time.time() - t0
        log(f"[time] layernorm {name}: {out[name]['seconds']:.1f} s")
        for k, v in part.items():
            launches[k] = launches.get(k, 0) + v
    out["launches"] = launches
    report["layernorm_path"] = out
    return launches


# --------------------------------------------------------------------------
# phase positions: learned positions and ALiBi at their published shapes


#: the published configs (config.json), cut in depth to fit the script's
#: time (widths untouched): bigcode/starcoder (GPTBigCode: n_embd 6,144, 48
#: heads, multi-query, n_inner 24,576, n_positions 8,192; 10 of its 40
#: layers) and mosaicml/mpt-7b (d_model 4,096, 32 heads, expansion_ratio 4,
#: no_bias, alibi_bias_max 8, tied embeddings; 8 of its 32 layers)
STARCODER_15B = dict(d=6144, f=24576, v=49152, n_layers=10, n_heads=48, n_kv_heads=1,
                     head_dim=128, ctx=8192, rope_base=10000.0)
MPT_7B = dict(d=4096, f=16384, v=50432, n_layers=8, n_heads=32, n_kv_heads=32, head_dim=128,
              ctx=2048, rope_base=10000.0)
#: launches per decoded token: wqkv, wo, w_up, w_down a layer (+ lm_head;
#: MPT's tied head is no qmm); StarCoder's attention a layer, MPT's none
STARCODER_GEMV, STARCODER_FLASH = STARCODER_15B["n_layers"] * 4 + 1, STARCODER_15B["n_layers"]
MPT_GEMV = MPT_7B["n_layers"] * 4
#: GPT-NeoX-20B's tokenizer (MPT-7B's): 50,254 BPE pieces, its specials,
#: padded to the model's 50,432 rows
MPT_PIECES, MPT_SPECIALS = 50254, ("<|endoftext|>", "<|padding|>")
MPT_MD = {"mpt.attention.max_alibi_bias": 8.0}
#: the CPU port's run on each cell's weights: a prompt's first tokens and
#: the greedy tokens after them (the prompt's, then one decode step's)
CPU_CHECK_PROMPT, CPU_CHECK_NEW = 16, 2


def cpu_copy(tree):
    """A copy of a params tree on the CPU (QTensors field by field)."""
    import dataclasses

    from eagle_tpu_torch.quant.qtensor import QTensor

    if isinstance(tree, dict):
        return {k: cpu_copy(v) for k, v in tree.items()}
    if isinstance(tree, QTensor):
        return dataclasses.replace(tree, **{k: None if v is None else v.cpu()
                                            for k, v in tree.tensors().items()})
    return tree if tree is None else tree.cpu()


def cpu_tokens(params, cfg, ids: list) -> dict:
    """The CPU port (plain versions, bf16 compute and cache) on `params`
    (a CPU copy of a cell's weights): greedy `CPU_CHECK_NEW` tokens after
    `ids`, and the seconds it took. Runs on the phase's worker thread."""
    import torch

    from eagle_tpu_torch.runtime.generate import Generator

    t0 = time.time()
    gen = Generator(params, cfg, max_seq=64, kv_dtype=torch.bfloat16,
                    compute_dtype=torch.bfloat16, eos_id=-1, device="cpu")
    toks = gen.generate(ids, max_new_tokens=CPU_CHECK_NEW, stop_at_eos=False)
    return dict(tokens=toks, seconds=time.time() - t0)


def cpu_tokens_finish(tag: str, eng, ids: list, future) -> dict:
    """Wait for a cell's CPU run (`cpu_tokens` on the worker thread); the
    card's greedy tokens (the same Generator settings, the kernels) must
    equal its tokens up to the near-tie rule."""
    import torch

    from eagle_tpu_torch.runtime.generate import Generator

    t0 = time.time()
    cpu = future.result()  # re-raises what the worker raised
    wait = time.time() - t0
    # max_seq 1,024: `check_near_tie` prefills a 512-row bucket on it
    gen = Generator(eng.params, eng.model_cfg, max_seq=1024, kv_dtype=torch.bfloat16,
                    compute_dtype=torch.bfloat16, eos_id=-1)
    card = gen.generate(ids, max_new_tokens=CPU_CHECK_NEW, stop_at_eos=False)
    tie = check_near_tie(gen, ids, card, cpu["tokens"], tag, "the CPU port vs the card")
    log(f"[{tag}] the CPU port's greedy tokens on the same weights ({len(ids)}-token prompt, "
        f"{CPU_CHECK_NEW} new): {cpu['tokens']}, the card's {card}; the CPU run took "
        f"{cpu['seconds']:.1f} s, waited for {wait:.1f} s after the kernel checks")
    return dict(prompt_tokens=len(ids), cpu_tokens=cpu["tokens"], card_tokens=card,
                equal=cpu["tokens"] == card, near_tie=tie, cpu_seconds=cpu["seconds"],
                wait_seconds=wait)


def gqa_prompt_check(gen, tag: str = "positions kernel", h: int = 48, h_kv: int = 1,
                     d: int = 128) -> dict:
    """flash_decode at the EAGLE engine's prompt (the chain's prefill reads
    through decode attention) at h query heads over h_kv KV heads of `d`
    (StarCoder-15B's g = 48 by default): T = 512 over 512 slots, 300
    tagged, the causal tag mask (T·g 24,576 at g = 48), against its plain
    version, timed beside SDPA (`enable_gqa`)."""
    import torch
    import torch.nn.functional as F

    from eagle_tpu_torch.ops import flash_attention as fa
    from eagle_tpu_torch.runtime.kvcache import causal_mask_from_tags

    s, t, n, layer, g = 512, 512, 300, 1, h // h_kv
    kc = torch.randn((2, 1, h_kv, s, d), generator=gen, device="cuda").to(torch.bfloat16)
    vc = torch.randn((2, 1, h_kv, s, d), generator=gen, device="cuda").to(torch.bfloat16)
    tags = torch.full((1, s), -1, dtype=torch.int32, device="cuda")
    tags[:, :n] = torch.arange(n, dtype=torch.int32, device="cuda")
    pos = torch.arange(t, dtype=torch.int32, device="cuda")[None]
    mask = causal_mask_from_tags(tags, pos)
    q = torch.randn((1, t, h, d), generator=gen, device="cuda")
    got = fa.flash_attention_cached(q, kc, vc, mask, layer, s_limit=s)
    abs_err, rel = rel_err(got, fa.flash_attention_cached_plain(q, kc, vc, mask, layer,
                                                                s_limit=s))
    if rel > ATTN_TOL:
        raise AssertionError(f"{tag} flash_decode g={g} T={t}: rel err {rel:.3e}")
    ms = device_ms(lambda i: fa.flash_attention_cached(q, kc, vc, mask, layer, s_limit=s), 10)
    plain = device_ms(lambda i: fa.flash_attention_cached_plain(q, kc, vc, mask, layer,
                                                               s_limit=s), 5)
    qb = q.transpose(1, 2).to(torch.bfloat16)
    lib = device_ms(lambda i: F.scaled_dot_product_attention(
        qb, kc[layer], vc[layer], attn_mask=mask[:, None], enable_gqa=True), 10)
    b_ms, b_by = decode_bound(q, kc, mask)
    log(f"[{tag}] flash_decode g={g} T={t} (T*g={t * g}) S={s} D={d} ({n} tagged, the "
        f"EAGLE prompt) kernel {ms:.4f} ms  plain {plain:.4f} ms  bound {b_ms * 1e3:.2f} us "
        f"({b_by})  library {lib:.4f} ms  rel err {rel:.2e}")
    del kc, vc
    torch.cuda.empty_cache()
    return dict(name="flash_decode", g=g, d=d, t=t, s=s, ms=ms, plain_ms=plain, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib, max_abs_err=abs_err, rel_err=rel)


def alibi_attention_checks(gen, cfg, tag: str) -> list:
    """An ALiBi model's attention on the plain `gqa_attention` (the
    reference's flash gates refuse ALiBi), at its heads, bf16 cache: a
    decoded row and a K = 5 verify over 1,024 slots (364 visible) and a
    512-row prompt (300 real rows). Its ms per call against the bound (K and
    V of the visible slots once; the score and value products at the bf16
    rate) and against SDPA given the bias and the mask as one float
    attn_mask [1, H, T, S] (made outside the timed call): in f32 on the
    cache's values, as the plain read computes (the library time; its output
    held against the plain one at ATTN_TOL), and in bf16 (timed and its
    error logged: bf16 rounds the bias, by up to 1 at a distance of 300)."""
    import torch
    import torch.nn.functional as F

    from eagle_tpu_torch.models.llama import alibi_slopes
    from eagle_tpu_torch.ops.attention import gqa_attention
    from eagle_tpu_torch.runtime.kvcache import causal_mask_from_tags

    h, h_kv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    slopes = alibi_slopes(h, "cuda")
    out = []
    for t, s, n in ((1, 1024, 364), (VERIFY_ROWS, 1024, 364), (512, 512, 300)):
        kc = torch.randn((1, h_kv, s, d), generator=gen, device="cuda").to(torch.bfloat16)
        vc = torch.randn((1, h_kv, s, d), generator=gen, device="cuda").to(torch.bfloat16)
        tags = torch.full((1, s), -1, dtype=torch.int32, device="cuda")
        tags[:, :n] = torch.arange(n, dtype=torch.int32, device="cuda")
        pos = (torch.arange(t, dtype=torch.int32, device="cuda") + (n - t if t < n else 0))[None]
        mask = causal_mask_from_tags(tags, pos)
        q = torch.randn((1, t, h, d), generator=gen, device="cuda")
        run = lambda i: gqa_attention(q, kc, vc, mask, scale=cfg.attn_scale,  # noqa: E731
                                      alibi=slopes, q_pos=pos, k_pos=tags)
        got = run(0)
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{tag} ALiBi attention T={t}: non-finite output")
        ms = device_ms(run, 20)
        dist = (pos[:, :, None] - tags[:, None, :]).float()
        bias = torch.where(mask[:, None], -slopes[None, :, None, None] * dist[:, None],
                           float("-inf"))
        libs = {}
        for dt in (torch.float32, torch.bfloat16):
            qd, kd, vd, bd = (t.to(dt) for t in (q.to(kc.dtype).transpose(1, 2), kc, vc, bias))
            fn = lambda i: F.scaled_dot_product_attention(  # noqa: E731
                qd, kd, vd, attn_mask=bd, scale=cfg.attn_scale, enable_gqa=h != h_kv)
            libs[dt] = (device_ms(fn, 20), rel_err(fn(0).transpose(1, 2), got)[1])
        (lib, lib_err), (lib_bf16, bf16_err) = libs[torch.float32], libs[torch.bfloat16]
        if lib_err > ATTN_TOL:
            raise AssertionError(f"{tag} ALiBi attention T={t}: SDPA (f32) against the plain "
                                 f"read: rel err {lib_err:.3e}")
        pairs = int(mask.sum())
        b_ms, b_by = bound_ms(2 * n * h_kv * d * 2 + nbytes(q, mask) + q.numel() * 4,
                              4.0 * pairs * h * d)
        out.append(dict(name="gqa_attention (plain, ALiBi)", t=t, s=s, visible=n, ms=ms,
                        bound_ms=b_ms, bound_by=b_by, library_ms=lib, library_rel_err=lib_err,
                        library_bf16_ms=lib_bf16, library_bf16_rel_err=bf16_err,
                        per_token_ms=ms * cfg.n_layers if t == 1 else None))
        log(f"[{tag}] plain ALiBi attention T={t} S={s} ({n} visible) H={h}/{h_kv} D={d}: "
            f"{ms:.4f} ms per call"
            + (f" ({ms * cfg.n_layers:.3f} ms per token over {cfg.n_layers} layers)"
               if t == 1 else "")
            + f", bound {b_ms * 1e3:.2f} us ({b_by}), library {lib:.4f} ms (SDPA in f32, the "
            f"bias and mask as one attn_mask; rel err {lib_err:.2e}), in bf16 {lib_bf16:.4f} ms "
            f"(rel err {bf16_err:.2e})")
        del kc, vc, bias
    torch.cuda.empty_cache()
    return out


def starcoder_setup(tmp: pathlib.Path, gen, cpu) -> dict:
    """StarCoder-15B's shape (learned positions, LayerNorm with biases, a
    fused attn_qkv with its bias, a no-gate GELU MLP with biases, 48 query
    heads over one KV head of 128: g = 48) at 10 of its 40 layers, with a
    49,152-entry BPE vocabulary ("starcoder" pre-tokenizer) and an EAGLE
    Q8_0 draft at its widths, minted and loaded through `Engine`; the CPU
    port's greedy tokens submitted to `cpu` (the phase's worker thread);
    qmm at the path's shapes at 1, 6 and 300 rows and the draft's fc, both
    flash kernels at g = 48. Returns the cell's state for `starcoder_run`."""
    from eagle_tpu_torch.tokenizer import BPETokenizer

    c = STARCODER_15B
    t0 = time.time()
    vocab, words = bpe_vocab(191, c["v"], c["v"] - len(STARCODER2_SPECIALS), STARCODER2_SPECIALS,
                            "starcoder")
    out: dict = {"vocab_s": time.time() - t0}
    eng, out["files"] = family_load("starcoder-15b", c, tmp, 193, vocab, "starcoder",
                                    with_draft=True, phase="positions")
    params, draft, cfg, dcfg = eng.params, eng.draft_params, eng.model_cfg, eng.draft_cfg
    tok = eng.tokenizer
    layers = params["layers"]
    if (not isinstance(tok, BPETokenizer) or cfg.norm_type != "layer" or cfg.rope_dim != 0
            or not cfg.has_pos_embd or cfg.use_alibi or cfg.act != "gelu"
            or "w_gate_up" in layers or tuple(params["pos_embd"].shape) != (c["ctx"], c["d"])
            or not {"bqkv", "bo", "b_up", "b_down", "attn_norm_b", "ffn_norm_b"} <= set(layers)
            or params["output"].layout != "kn" or (dcfg.arch, dcfg.n_kv_heads) != ("eagle", 1)):
        raise AssertionError(f"starcoder: the files did not load as StarCoder + EAGLE: {cfg}")
    text = llama3_text(tok, words, FAMILY_PROMPT_TOKENS, seed=197)
    ids = tok.encode(text)
    if tok.decode(ids) != text:
        raise AssertionError("starcoder: the prompt does not round-trip through the tokenizer")
    out["prompt_tokens"] = len(ids)
    head = ids[:CPU_CHECK_PROMPT]
    future = cpu.submit(cpu_tokens, cpu_copy(params), cfg, head)
    out["qmm"] = family_kernels("starcoder", params, gen, (
        (1, "qmm_gemv", "decoded token"), (VERIFY_ROWS, "qmm_mma", "verify cycle"),
        (FAMILY_PROMPT_TOKENS, "qmm_tc", "300-row prompt")), draft=draft,
        log_tag="positions kernel")
    out["attention"] = (gqa_flash_checks(gen, "positions kernel", c["n_heads"], c["n_kv_heads"])
                        + [gqa_prompt_check(gen)])
    return dict(tag="starcoder", eng=eng, ids=ids, head=head, future=future, out=out)


def starcoder_run(st: dict) -> tuple[dict, dict]:
    """`serve_cell` on the StarCoder cell (greedy and the chain at C = 1 and
    4, eager and graphed, 2 runs each): 41 qmm_gemv and 10 flash_decode per
    decoded token, 41 qmm_mma per verify, 10 flash_prefill per greedy
    prompt. Returns (the cell, the default path's launches)."""
    import numpy as np

    eng, out = st["eng"], st["out"]
    want_tok = {"qmm_gemv": STARCODER_GEMV, "flash_decode": STARCODER_FLASH,
                "ffn_out_norm": 0, "gate_up_act": 0, "qmm": 0}
    os.environ.pop("EAGLE_TPU_FUSED_FFN", None)
    cell = serve_cell("starcoder", eng.params, eng.draft_params, eng.model_cfg, eng.draft_cfg,
                      np.asarray(st["ids"]), FAMILY_NEW, want_tok, STARCODER_GEMV, fused=False)
    cell.pop("gen")
    prompt = cell["variants"]["greedy graphed"]["launches_at_first_token"]
    if prompt["flash_prefill"] != STARCODER_FLASH or prompt["flash_decode"]:
        raise AssertionError(f"starcoder: the greedy prompt's attention launches {prompt}, "
                             f"expected {STARCODER_FLASH} flash_prefill")
    log(f"[starcoder] the greedy prompt: {prompt['flash_prefill']} flash_prefill, "
        f"{prompt['qmm_tc']} qmm_tc; EAGLE == greedy: "
        f"{cell['eagle_tokens'] == cell['greedy_tokens']}")
    out["cell"] = cell
    return out, dict(cell["variants"]["eagle graphed C=1"]["launches"])


def mpt_setup(tmp: pathlib.Path, gen, cpu) -> dict:
    """MPT-7B's shape (ALiBi over 32 heads of 128, LayerNorm without biases,
    a fused attn_qkv, a no-gate GELU MLP, no bias anywhere, a tied Q6_K
    head) at 8 of its 32 layers, with a 50,432-entry BPE vocabulary ("mpt"
    pre-tokenizer) and an EAGLE Q8_0 draft at its widths, minted and loaded
    through `Engine`; the CPU port's greedy tokens submitted to `cpu`; qmm
    at the path's shapes at 1, 6 and 300 rows and the draft's fc, the plain
    ALiBi read beside SDPA, the tied head. Returns the cell's state for
    `mpt_run`."""
    from eagle_tpu_torch.tokenizer import BPETokenizer

    c = MPT_7B
    t0 = time.time()
    vocab, words = bpe_vocab(199, c["v"], MPT_PIECES, MPT_SPECIALS, "mpt")
    out: dict = {"vocab_s": time.time() - t0}
    eng, out["files"] = family_load("mpt-7b", c, tmp, 211, vocab, "mpt", with_draft=True,
                                    metadata=MPT_MD, tied=True, phase="positions")
    params, draft, cfg, dcfg = eng.params, eng.draft_params, eng.model_cfg, eng.draft_cfg
    tok = eng.tokenizer
    layers = params["layers"]
    if (not isinstance(tok, BPETokenizer) or cfg.norm_type != "layer" or cfg.rope_dim != 0
            or cfg.has_pos_embd or not cfg.use_alibi or cfg.act != "gelu"
            or set(layers) != {"attn_norm", "ffn_norm", "wqkv", "wo", "w_up", "w_down"}
            or params["output"].layout != "nk" or "output_norm_b" in params
            or dcfg.arch != "eagle"):
        raise AssertionError(f"mpt: the files did not load as MPT + EAGLE: {cfg}")
    text = llama3_text(tok, words, FAMILY_PROMPT_TOKENS, seed=223)
    ids = tok.encode(text)
    if tok.decode(ids) != text:
        raise AssertionError("mpt: the prompt does not round-trip through the tokenizer")
    out["prompt_tokens"] = len(ids)
    head = ids[:CPU_CHECK_PROMPT]
    future = cpu.submit(cpu_tokens, cpu_copy(params), cfg, head)
    out["qmm"] = family_kernels("mpt", params, gen, (
        (1, "qmm_gemv", "decoded token"), (VERIFY_ROWS, "qmm_mma", "verify cycle"),
        (FAMILY_PROMPT_TOKENS, "qmm_tc", "300-row prompt")), draft=draft,
        log_tag="positions kernel")
    out["attention"] = alibi_attention_checks(gen, cfg, "positions kernel")
    out["head"] = nk_head_check("mpt", params["output"], cfg)
    return dict(tag="mpt", eng=eng, ids=ids, head=head, future=future, out=out)


def mpt_run(st: dict) -> tuple[dict, dict]:
    """`serve_cell` on the MPT cell (greedy and the chain at C = 1 and 4,
    eager and graphed, 2 runs each): 32 qmm_gemv and no flash kernel per
    decoded token (the draft's attention is flash_decode), 32 qmm_mma per
    verify. Returns (the cell, the default path's launches)."""
    import numpy as np

    eng, out = st["eng"], st["out"]
    want_tok = {"qmm_gemv": MPT_GEMV, "flash_decode": 0, "flash_prefill": 0,
                "ffn_out_norm": 0, "gate_up_act": 0, "qmm": 0}
    os.environ.pop("EAGLE_TPU_FUSED_FFN", None)
    cell = serve_cell("mpt", eng.params, eng.draft_params, eng.model_cfg, eng.draft_cfg,
                      np.asarray(st["ids"]), FAMILY_NEW, want_tok, MPT_GEMV, fused=False,
                      kernels=tuple(k for k in CORE_KERNELS if k != "flash_prefill"))
    cell.pop("gen")
    prompt = cell["variants"]["greedy graphed"]["launches_at_first_token"]
    if prompt["flash_prefill"] or prompt["flash_decode"]:
        raise AssertionError(f"mpt: a flash kernel ran in the greedy prompt: {prompt}")
    log(f"[mpt] the greedy prompt: no flash kernel (the plain ALiBi read), {prompt['qmm_tc']} "
        f"qmm_tc; EAGLE == greedy: {cell['eagle_tokens'] == cell['greedy_tokens']}")
    out["cell"] = cell
    return out, dict(cell["variants"]["eagle graphed C=1"]["launches"])


def positions_path(report: dict, tmp: pathlib.Path) -> dict:
    """Phase positions: the StarCoder-15B (+ EAGLE) and MPT-7B (+ EAGLE)
    cells, minted into `tmp` and loaded through `Engine` both, their kernels
    checked at their shapes while one worker thread runs the CPU port on a
    copy of each cell's weights (its tokens then held against the card's),
    then each run (host-timed, with the worker done) and freed. Returns the
    launches of both default paths (greedy + EAGLE graphed at C = 1),
    added."""
    import gc
    import shutil
    from concurrent.futures import ThreadPoolExecutor

    import torch

    if shutil.disk_usage(tmp).free < 6 * 2**30:
        raise RuntimeError("phase positions needs 6 GiB of disk")
    gen = torch.Generator(device="cuda").manual_seed(187)
    t0 = time.time()
    with ThreadPoolExecutor(max_workers=1, thread_name_prefix="cpu-port") as cpu:
        cells = [starcoder_setup(tmp, gen, cpu), mpt_setup(tmp, gen, cpu)]
        for st in cells:
            st["out"]["cpu"] = cpu_tokens_finish(st["tag"], st["eng"], st["head"],
                                                 st.pop("future"))
    log(f"[time] positions setup (both cells' loads, kernel checks and CPU runs): "
        f"{time.time() - t0:.1f} s")
    out: dict = {}
    launches: dict = {}
    for st, run in zip(cells, (starcoder_run, mpt_run)):
        t0 = time.time()
        tag = st["tag"]
        out[tag], part = run(st)
        st.clear()  # the engine and its weights
        gc.collect()
        torch.cuda.empty_cache()
        out[tag]["seconds"] = time.time() - t0
        log(f"[time] positions {tag}: {out[tag]['seconds']:.1f} s (the run)")
        for k, v in part.items():
            launches[k] = launches.get(k, 0) + v
    out["launches"] = launches
    report["positions_path"] = out
    return launches


# --------------------------------------------------------------------------
# phase lnfamilies: the other LayerNorm families at their published shapes


#: the published configs (config.json), cut in depth to fit the script's
#: time (widths untouched): tiiuae/falcon-7b (hidden 4,544, 71 heads of 64,
#: multi_query, FFN 4 x 4,544, vocab 65,024, parallel_attn, one LayerNorm;
#: 8 of its 32 layers) and nvidia/Minitron-8B-Base (hidden 4,096, 48 heads
#: of 128 over 8 KV heads, intermediate 16,384, relu2, partial_rotary_factor
#: 0.5, vocab 256,000, untied; 8 of its 32 layers)
FALCON_7B = dict(d=4544, f=18176, v=65024, n_layers=8, n_heads=71, n_kv_heads=1, head_dim=64,
                 ctx=2048, rope_base=10000.0)
MINITRON_8B = dict(d=4096, f=16384, v=256000, n_layers=8, n_heads=48, n_kv_heads=8,
                   head_dim=128, ctx=4096, rope_base=10000.0, rope_dim=64)
#: llama-quantize's Q4_K_M on Falcon-7B: K = 4,544 is no multiple of 256, so
#: its Q4_K tensors fall back to Q5_0 and the Q6_K head to Q8_0; w_down (K =
#: 18,176) stays Q4_K (Q4_K_M's Q6_K layers left out, as in every minted cell)
FALCON_TYPES = {"attn_qkv": "Q5_0", "attn_output": "Q5_0", "ffn_up": "Q5_0",
                "ffn_down": "Q4_K", "token_embd": "Q5_0", "output": "Q8_0"}
#: Falcon's specials (its first 12 ids in the published file; here at the
#: end of the minted pieces)
FALCON_SPECIALS = (">>TITLE<<", ">>ABSTRACT<<", ">>INTRODUCTION<<", ">>SUMMARY<<",
                   ">>COMMENT<<", ">>ANSWER<<", ">>QUESTION<<", ">>DOMAIN<<", ">>PREFIX<<",
                   ">>SUFFIX<<", ">>MIDDLE<<", "<|endoftext|>")
#: launches per decoded token: wqkv, wo, w_up, w_down a layer + lm_head; a
#: flash_decode a layer
FALCON_GEMV, FALCON_FLASH = FALCON_7B["n_layers"] * 4 + 1, FALCON_7B["n_layers"]
MINITRON_GEMV, MINITRON_FLASH = MINITRON_8B["n_layers"] * 4 + 1, MINITRON_8B["n_layers"]
#: the 2-layer checks at published widths (config.json): allenai/OLMo-1.7-7B-hf
#: (4,096, 32 heads, 11,008, clip_qkv 8, vocab 50,304), OrionStarAI/
#: Orion-14B-Base (5,120, 40 heads, 15,360, vocab 84,608), WisdomShell/
#: CodeShell-7B (4,096, 32 heads over 8 KV heads, 16,384, vocab 70,144) and
#: EleutherAI/gpt-j-6b (4,096, 16 heads of 256, rotary_dim 64, 16,384, vocab
#: 50,400); each with its tokenizer and the minting arguments of its layout
LNF_CHECKS = {
    "olmo": dict(d=4096, f=11008, v=50304, n_layers=2, n_heads=32, n_kv_heads=32,
                 head_dim=128, ctx=4096, rope_base=10000.0, pieces=50280,
                 specials=("<|endoftext|>", "<|padding|>"), pre="gpt-2",
                 metadata={"olmo.attention.clamp_kqv": 8.0}),
    "orion": dict(d=5120, f=15360, v=84608, n_layers=2, n_heads=40, n_kv_heads=40,
                  head_dim=128, ctx=4096, rope_base=10000.0, pre="spm", metadata={}),
    "codeshell": dict(d=4096, f=16384, v=70144, n_layers=2, n_heads=32, n_kv_heads=8,
                      head_dim=128, ctx=8192, rope_base=10000.0, pieces=70000,
                      specials=("<|endoftext|>",), pre="codeshell", metadata={}),
    "gptj": dict(d=4096, f=16384, v=50400, n_layers=2, n_heads=16, n_kv_heads=16,
                 head_dim=256, ctx=2048, rope_base=10000.0, pieces=50256,
                 specials=("<|endoftext|>",), pre="gpt-2", metadata={}, rope_dim=64),
}
LNF_CHECK_NEW = 8  # greedy tokens of a 2-layer check, graphed and eager
LNF_CHECK_PROMPT = 64  # tokens of its prompt


def falcon_setup(tmp: pathlib.Path, gen, cpu) -> dict:
    """Falcon-7B's shape (one shared LayerNorm with its bias feeding
    attention and a no-bias GELU MLP in parallel, 71 query heads over one
    KV head of 64: g = 71, a fused attn_qkv, Q4_K_M's Q5_0 / Q4_K / Q8_0
    fallbacks at K = 4,544) at 8 of its 32 layers, with a 65,024-entry BPE
    vocabulary ("falcon" pre-tokenizer) and an EAGLE Q8_0 draft at its
    widths, minted and loaded through `Engine`; the CPU port's greedy
    tokens submitted to `cpu`; qmm at the path's shapes at 1, 6 and 300
    rows and the draft's fc, both flash kernels at g = 71 and D = 64 (the
    EAGLE prompt's 36,352 rows too). Returns the cell's state for
    `falcon_run`."""
    from eagle_tpu_torch.gguf import GGMLType
    from eagle_tpu_torch.tokenizer import BPETokenizer

    c = FALCON_7B
    t0 = time.time()
    vocab, words = bpe_vocab(227, c["v"], c["v"] - len(FALCON_SPECIALS), FALCON_SPECIALS,
                            "falcon")
    out: dict = {"vocab_s": time.time() - t0}
    eng, out["files"] = family_load("falcon-7b", c, tmp, 229, vocab, "falcon", with_draft=True,
                                    phase="lnfamilies", types=FALCON_TYPES)
    params, draft, cfg, dcfg = eng.params, eng.draft_params, eng.model_cfg, eng.draft_cfg
    tok = eng.tokenizer
    layers = params["layers"]
    types = {k: GGMLType(w.ggml_type).name for k, w in (
        *((k, layers[k]) for k in ("wqkv", "wo", "w_up", "w_down")),
        ("output", params["output"]), ("tok_embd", params["tok_embd"]))}
    want_types = {"wqkv": "Q5_0", "wo": "Q5_0", "w_up": "Q5_0", "w_down": "Q4_K",
                  "output": "Q8_0", "tok_embd": "Q5_0"}
    if (not isinstance(tok, BPETokenizer) or eng.metadata["tokenizer.ggml.pre"] != "falcon"
            or (cfg.norm_type, cfg.parallel_blocks, cfg.act, cfg.rope_dim) != (
                "layer", True, "gelu", 64)
            or set(layers) != {"attn_norm", "attn_norm_b", "wqkv", "wo", "w_up", "w_down"}
            or types != want_types or params["output"].layout != "kn"
            or "output_norm_b" not in params or (dcfg.arch, dcfg.n_kv_heads) != ("eagle", 1)):
        raise AssertionError(f"falcon: the files did not load as Falcon-7B + EAGLE: {cfg}, "
                             f"{types}")
    text = llama3_text(tok, words, FAMILY_PROMPT_TOKENS, seed=233)
    ids = tok.encode(text)
    if tok.decode(ids) != text:
        raise AssertionError("falcon: the prompt does not round-trip through the tokenizer")
    out["prompt_tokens"] = len(ids)
    head = ids[:CPU_CHECK_PROMPT]
    future = cpu.submit(cpu_tokens, cpu_copy(params), cfg, head)
    out["qmm"] = family_kernels("falcon", params, gen, (
        (1, "qmm_gemv", "decoded token"), (VERIFY_ROWS, "qmm_mma", "verify cycle"),
        (FAMILY_PROMPT_TOKENS, "qmm_tc", "300-row prompt")), draft=draft,
        log_tag="lnfamilies kernel")
    out["attention"] = (gqa_flash_checks(gen, "lnfamilies kernel", c["n_heads"], c["n_kv_heads"],
                                         d=c["head_dim"])
                        + [gqa_prompt_check(gen, "lnfamilies kernel", c["n_heads"],
                                            c["n_kv_heads"], c["head_dim"])])
    return dict(tag="falcon", eng=eng, ids=ids, head=head, future=future, out=out)


def falcon_run(st: dict) -> tuple[dict, dict]:
    """`serve_cell` on the Falcon cell (greedy and the chain at C = 1 and 4,
    eager and graphed, 2 runs each): 33 qmm_gemv and 8 flash_decode per
    decoded token, 33 qmm_mma per verify, 8 flash_prefill per greedy prompt.
    Returns (the cell, the default path's launches)."""
    import numpy as np

    eng, out = st["eng"], st["out"]
    want_tok = {"qmm_gemv": FALCON_GEMV, "flash_decode": FALCON_FLASH, "ffn_out_norm": 0,
                "gate_up_act": 0, "qmm": 0}
    os.environ.pop("EAGLE_TPU_FUSED_FFN", None)
    cell = serve_cell("falcon", eng.params, eng.draft_params, eng.model_cfg, eng.draft_cfg,
                      np.asarray(st["ids"]), FAMILY_NEW, want_tok, FALCON_GEMV, fused=False)
    cell.pop("gen")
    prompt = cell["variants"]["greedy graphed"]["launches_at_first_token"]
    if prompt["flash_prefill"] != FALCON_FLASH or prompt["flash_decode"]:
        raise AssertionError(f"falcon: the greedy prompt's attention launches {prompt}, "
                             f"expected {FALCON_FLASH} flash_prefill")
    log(f"[falcon] the greedy prompt: {prompt['flash_prefill']} flash_prefill, "
        f"{prompt['qmm_tc']} qmm_tc; EAGLE == greedy: "
        f"{cell['eagle_tokens'] == cell['greedy_tokens']}")
    out["cell"] = cell
    return out, dict(cell["variants"]["eagle graphed C=1"]["launches"])


def minitron_setup(tmp: pathlib.Path, gen, cpu) -> dict:
    """Minitron-8B's shape (nemotron: LayerNorm with biases, a no-gate
    squared-ReLU MLP, 64 of 128 features rotary, a 6,144-wide query over
    n_embd 4,096, 48 query heads over 8 KV heads: g = 6, a Q6_K head of
    256,000 rows) at 8 of its 32 layers, with an SPM vocabulary of 256,000
    pieces, minted and loaded through `Engine`; the CPU port's greedy tokens
    submitted to `cpu`; qmm at the path's shapes at 1 and 300 rows, both
    flash kernels at g = 6. Returns the cell's state for `minitron_run`."""
    from eagle_tpu_torch.tokenizer import SPMTokenizer

    c = MINITRON_8B
    t0 = time.time()
    vocab = spm_vocab(c["v"], seed=239)
    out: dict = {"vocab_s": time.time() - t0}
    eng, out["files"] = family_load("minitron-8b", c, tmp, 241, vocab, "nemotron",
                                    with_draft=False, phase="lnfamilies", rope_dim=c["rope_dim"])
    params, cfg = eng.params, eng.model_cfg
    layers = params["layers"]
    if (not isinstance(eng.tokenizer, SPMTokenizer)
            or (cfg.norm_type, cfg.parallel_blocks, cfg.act, cfg.rope_dim) != (
                "layer", False, "relu2", 64) or cfg.n_q_dim != 6144
            or set(layers) != {"attn_norm", "attn_norm_b", "ffn_norm", "ffn_norm_b", "wqkv",
                               "wo", "w_up", "w_down"}
            or params["output"].layout != "kn" or params["output"].shape != (c["v"], c["d"])):
        raise AssertionError(f"minitron: the file did not load as Minitron-8B: {cfg}")
    ids = eng.tokenizer.encode(cli_prompt(vocab["tokenizer.ggml.tokens"], FAMILY_PROMPT_TOKENS,
                                          seed=251))
    out["prompt_tokens"] = len(ids)
    head = ids[:CPU_CHECK_PROMPT]
    future = cpu.submit(cpu_tokens, cpu_copy(params), cfg, head)
    out["qmm"] = family_kernels("minitron", params, gen, (
        (1, "qmm_gemv", "decoded token"), (FAMILY_PROMPT_TOKENS, "qmm_tc", "300-row prompt")),
        log_tag="lnfamilies kernel")
    out["attention"] = gqa_flash_checks(gen, "lnfamilies kernel", c["n_heads"], c["n_kv_heads"])
    return dict(tag="minitron", eng=eng, ids=ids, head=head, future=future, out=out)


def minitron_run(st: dict) -> tuple[dict, dict]:
    """`greedy_cell` on the Minitron cell: 33 qmm_gemv (the 256,000-row head
    one of them) and 8 flash_decode per decoded token. Returns (the cell,
    the first timed run's launches)."""
    eng, out = st["eng"], st["out"]
    os.environ.pop("EAGLE_TPU_FUSED_FFN", None)
    out["cell"], launches = greedy_cell("minitron", eng, st["ids"], {
        "qmm_gemv": MINITRON_GEMV, "flash_decode": MINITRON_FLASH, "qmm": 0})
    if launches.get("flash_prefill") != MINITRON_FLASH:
        raise AssertionError(f"minitron: {launches.get('flash_prefill')} flash_prefill in the "
                             f"run, expected {MINITRON_FLASH} (the prompt)")
    return out, launches


def lnf_check(name: str, tmp: pathlib.Path, gen, cpu) -> tuple[dict, dict]:
    """A 2-layer model of `LNF_CHECKS[name]` at its published widths, minted
    (Q4_K layers, a Q6_K head) and loaded through `Engine`, its layout and
    config checked; `LNF_CHECK_NEW` greedy tokens eager, graphed to capture
    and graphed again, bit for bit, no eager body after the capture, no
    plain version; flash_decode, flash_prefill and qmm_gemv launched; then
    the CPU port's first greedy tokens on a copy of its weights (on `cpu`,
    after the card's runs: the CPU's plain versions count in the same
    counters) against the card's. GPT-J's flash kernels at its 16 heads of
    256 are timed meanwhile. Returns (the check, its graphed run's
    launches)."""
    from eagle_tpu_torch import _build
    from eagle_tpu_torch.runtime.generate import Generator

    c = LNF_CHECKS[name]
    seed = 257 + 6 * list(LNF_CHECKS).index(name)
    t0 = time.time()
    if c["pre"] == "spm":
        vocab = spm_vocab(c["v"], seed=seed)
        text = cli_prompt(vocab["tokenizer.ggml.tokens"], LNF_CHECK_PROMPT, seed=seed + 1)
    else:
        vocab, words = bpe_vocab(seed, c["v"], c["pieces"], c["specials"], c["pre"])
    out: dict = {"vocab_s": time.time() - t0}
    mint = {"rope_dim": c["rope_dim"]} if "rope_dim" in c else {}
    eng, out["files"] = family_load(f"{name}-2-layer", c, tmp, seed + 2, vocab, name,
                                    with_draft=False, metadata=c["metadata"],
                                    phase="lnfamilies", **mint)
    params, cfg, tok = eng.params, eng.model_cfg, eng.tokenizer
    layers = set(params["layers"])
    want = {"olmo": (cfg.nonparam_norms and cfg.clamp_kqv == 8.0 and cfg.act == "silu"
                     and layers == {"wqkv", "wo", "w_gate_up", "w_down"}
                     and "output_norm" not in params),
            "orion": (cfg.act == "silu" and not cfg.parallel_blocks
                      and {"attn_norm_b", "ffn_norm_b", "w_gate_up"} <= layers
                      and "output_norm_b" in params),
            "codeshell": (cfg.act == "gelu" and not cfg.parallel_blocks and cfg.n_kv_heads == 8
                          and {"bqkv", "bo", "w_up", "b_up", "b_down"} <= layers),
            "gptj": (cfg.act == "gelu" and cfg.parallel_blocks and cfg.rope_dim == 64
                     and "ffn_norm" not in layers and {"b_up", "b_down"} <= layers
                     and "output_b" in params)}[name]
    if not want or cfg.norm_type != "layer" or cfg.arch != name:
        raise AssertionError(f"{name}: the file did not load as its family: {cfg}, {layers}")
    if c["pre"] != "spm":
        text = llama3_text(tok, words, LNF_CHECK_PROMPT, seed=seed + 1)
    ids = tok.encode(text)[:LNF_CHECK_PROMPT]
    out["prompt_tokens"] = len(ids)
    g = Generator(params, cfg, max_seq=1024, eos_id=-1)

    def run():
        return g.generate(ids, max_new_tokens=LNF_CHECK_NEW, stop_at_eos=False)

    want_toks = eager_tokens(g, run)
    if run() != want_toks:  # the captures
        raise AssertionError(f"{name}: graphed tokens differ from eager")
    eager = g.graphs.eager
    _build.reset_counts()
    toks = run()
    launches = {k: v for k, v in _build.launches.items() if v}
    if toks != want_toks or g.graphs.eager != eager or any(_build.plain_calls.values()):
        raise AssertionError(f"{name}: the replayed run's tokens differ from eager, or a step "
                             f"ran eagerly, or a plain version ran")
    if not all(launches.get(k) for k in ("flash_decode", "flash_prefill", "qmm_gemv")):
        raise AssertionError(f"{name}: launches {launches}: a kernel of the path was not taken")
    out.update(tokens=toks, launches=launches)
    log(f"[{name}] 2 layers at its published widths: {LNF_CHECK_NEW} greedy tokens graphed == "
        f"eager bit for bit; launches of the replayed run "
        + ", ".join(f"{k} {launches.get(k, 0)}" for k in CORE_KERNELS))
    # the CPU run only now: its plain versions count in `_build.plain_calls`
    head = ids[:CPU_CHECK_PROMPT]
    future = cpu.submit(cpu_tokens, cpu_copy(params), cfg, head)
    if name == "gptj":
        out["attention"] = gqa_flash_checks(gen, "lnfamilies kernel", c["n_heads"],
                                            c["n_kv_heads"], d=c["head_dim"])
    out["cpu"] = cpu_tokens_finish(name, eng, head, future)
    return out, launches


def lnfamilies_path(report: dict, tmp: pathlib.Path) -> dict:
    """Phase lnfamilies: the Falcon-7B (+ EAGLE) and Minitron-8B cells,
    minted into `tmp` and loaded through `Engine` both, their kernels
    checked at their shapes while one worker thread runs the CPU port on a
    copy of each cell's weights (its tokens then held against the card's),
    then each run and freed; then the 2-layer OLMo, Orion, CodeShell and
    GPT-J checks, one at a time. Returns the launches of the Falcon default
    path (greedy + EAGLE graphed at C = 1), of the Minitron cell's first
    timed graphed run and of the checks' replayed runs, added."""
    import gc
    import shutil
    from concurrent.futures import ThreadPoolExecutor

    import torch

    if shutil.disk_usage(tmp).free < 8 * 2**30:
        raise RuntimeError("phase lnfamilies needs 8 GiB of disk")
    gen = torch.Generator(device="cuda").manual_seed(223)
    out: dict = {}
    launches: dict = {}

    def add(part):
        for k, v in part.items():
            launches[k] = launches.get(k, 0) + v

    t0 = time.time()
    with ThreadPoolExecutor(max_workers=1, thread_name_prefix="cpu-port") as cpu:
        cells = [falcon_setup(tmp, gen, cpu), minitron_setup(tmp, gen, cpu)]
        for st in cells:
            st["out"]["cpu"] = cpu_tokens_finish(st["tag"], st["eng"], st["head"],
                                                 st.pop("future"))
        log(f"[time] lnfamilies setup (both cells' loads, kernel checks and CPU runs): "
            f"{time.time() - t0:.1f} s")
        for st, run in zip(cells, (falcon_run, minitron_run)):
            t0 = time.time()
            tag = st["tag"]
            out[tag], part = run(st)
            st.clear()  # the engine and its weights
            gc.collect()
            torch.cuda.empty_cache()
            out[tag]["seconds"] = time.time() - t0
            log(f"[time] lnfamilies {tag}: {out[tag]['seconds']:.1f} s (the run)")
            add(part)
        for name in LNF_CHECKS:
            t0 = time.time()
            out[name], part = lnf_check(name, tmp, gen, cpu)
            gc.collect()
            torch.cuda.empty_cache()
            out[name]["seconds"] = time.time() - t0
            log(f"[time] lnfamilies {name}: {out[name]['seconds']:.1f} s")
            add(part)
    out["launches"] = launches
    report["lnfamilies_path"] = out
    return launches


# --------------------------------------------------------------------------
# phase moe: the mixture-of-experts families at their published widths


#: the published configs (config.json), cut in depth to fit the script's time
#: (widths untouched): mistralai/Mixtral-8x7B-v0.1 (hidden 4,096, 32 heads
#: over 8 KV heads of 128, 8 experts of 14,336, 2 a token, vocab 32,000,
#: rope_theta 1e6; 4 of its 32 layers), written as llama.cpp writes it
#: (`llama` with `llama.expert_count`), and Qwen/Qwen1.5-MoE-A2.7B (hidden
#: 2,048, 16 / 16 heads of 128, 60 experts of 1,408, 4 a token, a shared
#: expert of 5,632 under a sigmoid gate, q/k/v biases, vocab 151,936,
#: rope_theta 1e6; 8 of its 24 layers)
MIXTRAL_8X7B = dict(d=4096, f=14336, v=32000, n_layers=4, n_heads=32, n_kv_heads=8,
                    head_dim=128, ctx=32768, rope_base=1e6)
MIXTRAL_MOE = dict(n_expert=8, n_used=2, f_exp=14336, shexp=0)
QWEN_MOE_A27B = dict(d=2048, f=5632, v=151936, n_layers=8, n_heads=16, n_kv_heads=16,
                     head_dim=128, ctx=8192, rope_base=1e6)
QWEN_MOE = dict(n_expert=60, n_used=4, f_exp=1408, shexp=5632)
#: llama-quantize's Q4_K_M less its Q6_K layers: Q4_K everywhere, and the
#: experts' down products of Qwen1.5-MoE (K = 1,408, no multiple of 256)
#: fall back to Q5_0
QWEN_MOE_TYPES = {"ffn_down_exps": "Q5_0"}
#: launches per decoded token: wqkv and wo a layer + lm_head (the experts
#: are dense cuBLAS products, no qmm); a flash_decode a layer
MIXTRAL_GEMV, MIXTRAL_FLASH = MIXTRAL_8X7B["n_layers"] * 2 + 1, MIXTRAL_8X7B["n_layers"]
QWEN_MOE_GEMV, QWEN_MOE_FLASH = QWEN_MOE_A27B["n_layers"] * 2 + 1, QWEN_MOE_A27B["n_layers"]
#: the dense MoE weights of a layer (the router, the experts, the shared
#: expert and its gate)
MOE_KEYS = ("ffn_gate_inp", "w_gate_exps", "w_up_exps", "w_down_exps", "w_gate_shexp",
            "w_up_shexp", "w_down_shexp", "ffn_gate_inp_shexp")


def host_gib() -> dict:
    """This process's resident host memory now (/proc/self/status VmRSS)
    and its peak so far (getrusage's ru_maxrss), GiB."""
    import resource

    out = {"peak": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20}
    for line in pathlib.Path("/proc/self/status").read_text().splitlines():
        if line.startswith("VmRSS:"):
            out["now"] = int(line.split()[1]) / 2**20
    return out


def moe_dense_check(eng, target) -> dict:
    """The card's dense experts against the CPU's decode of the file's
    bytes: expert 0 of layer 0's gate stack and the last expert of its down
    stack, each `quant/qtensor.py:dequantize` on the CPU rounded to bf16,
    equal bit for bit to the loaded tensors."""
    import torch

    from eagle_tpu_torch.gguf.constants import ggml_row_bytes
    from eagle_tpu_torch.gguf.reader import GGUFReader
    from eagle_tpu_torch.quant.qtensor import dequantize

    out = {}
    reader = GGUFReader(target)
    for suffix, key, e in (("ffn_gate_exps", "w_gate_exps", 0), ("ffn_down_exps", "w_down_exps",
                                                                   -1)):
        info = reader.tensors[f"blk.0.{suffix}.weight"]
        n_exp, n, k = info.shape
        e %= n_exp
        size = n * ggml_row_bytes(info.ggml_type, k)
        raw = torch.from_numpy(reader.tensor_bytes(info.name)[e * size:(e + 1) * size].copy())
        want = dequantize(raw, info.ggml_type, (n, k)).to(torch.bfloat16)
        got = eng.params["layers"][key][0, e].cpu()
        if got.dtype != torch.bfloat16 or not torch.equal(got.view(torch.int16),
                                                          want.view(torch.int16)):
            raise AssertionError(f"{info.name} expert {e}: the card's dense read differs from "
                                 "the CPU's")
        out[key] = f"{info.ggml_type.name} [{n} x {k}] expert {e}: bit-equal"
    reader.close()
    return out


def moe_ffn_times(tag: str, eng, gen) -> list:
    """`_moe_ffn` of the cell at 1, 6 and 300 rows (a decoded token's, a
    verify's and the prompt's rows) of bf16 values: held against the same
    function on the f32 copy of layer 0's weights (rel err <= 1e-2), then
    timed as a CUDA graph of one call a layer, cycled over the layers, with
    its bound: the layer's dense weights read once (bf16), x read and the
    f32 output written; two operations per weight and row."""
    import torch
    import torch.nn.functional as F

    from eagle_tpu_torch.models.llama import _moe_ffn

    cfg, lay = eng.model_cfg, eng.params["layers"]
    n_layers, d = cfg.n_layers, cfg.n_embd
    keys = [k for k in MOE_KEYS if k in lay]
    w_bytes = nbytes(*(lay[k][0] for k in keys))
    w_numel = sum(lay[k][0].numel() for k in keys)
    f32 = {k: lay[k][:1].float() for k in keys}
    out = []
    for rows, what in ((1, "decoded token"), (VERIFY_ROWS, "verify cycle"),
                       (FAMILY_PROMPT_TOKENS, "300-row prompt")):
        # bf16 values in f32: both versions route on the same logits up to
        # the order of their f32 sums (a bf16-rounded x would move rows at a
        # near tie of the k-th logit onto other experts)
        x32 = torch.randn((1, rows, d), generator=gen, device="cuda")
        x = x32.to(torch.bfloat16).float()
        got = _moe_ffn(cfg, lay, 0, x, F.silu, torch.bfloat16)
        abs_err, rel = rel_err(got, _moe_ffn(cfg, f32, 0, x, F.silu, torch.float32))
        if rel > QMM_TOL or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{tag} experts at {rows} rows: rel err {rel:.3e}")
        ms = device_ms(lambda i: _moe_ffn(cfg, lay, i % n_layers, x, F.silu, torch.bfloat16),
                       2 * n_layers)
        b_ms, b_by = bound_ms(w_bytes + x.numel() * 4 + rows * d * 4, 2.0 * rows * w_numel)
        r = dict(rows=rows, per=what, ms=ms, bound_ms=b_ms, bound_by=b_by,
                 ms_per_forward=ms * n_layers, bound_ms_per_forward=b_ms * n_layers,
                 max_abs_err=abs_err, rel_err=rel, layer_bytes=w_bytes)
        out.append(r)
        log(f"[moe kernel] {tag} experts (dense cuBLAS products, {w_bytes / 1e9:.3f} GB of bf16 "
            f"weights a layer) at {rows} rows: {ms:.4f} ms a layer, bound {b_ms:.4f} ms "
            f"({b_by}, {ms / b_ms:.2f}x); per {what} ({n_layers} layers) {ms * n_layers:.3f} ms, "
            f"bound {b_ms * n_layers:.3f} ms; rel err vs f32 {rel:.2e}")
    out[-1]["route_witness"] = moe_route_witness(tag, cfg, lay, f32, x32)
    del f32
    torch.cuda.empty_cache()
    return out


def moe_route_witness(tag: str, cfg, lay: dict, f32: dict, x) -> dict:
    """Why `moe_ffn_times` feeds bf16 values: on f32 x (its last draw before
    the rounding), the bf16 path routes on x rounded to bf16 and the f32
    path on x itself, so rows near a tie at the k-th router logit keep
    other experts. Counts the rows whose kept set differs between the two
    routers, and the bf16 path's rel err against the f32 path's over all
    rows and over the rows that kept the same experts."""
    import torch
    import torch.nn.functional as F

    from eagle_tpu_torch.models.llama import _moe_ffn

    rows = x.shape[1]
    w_router = f32["ffn_gate_inp"][0]

    def kept(xs):
        logits = xs[0] @ w_router.t()
        return logits >= torch.topk(logits, cfg.n_expert_used, dim=-1).values[..., -1:]

    same = (kept(x.to(torch.bfloat16).float()) == kept(x)).all(-1)
    got = _moe_ffn(cfg, lay, 0, x, F.silu, torch.bfloat16)[0]
    want = _moe_ffn(cfg, f32, 0, x, F.silu, torch.float32)[0]
    _, rel_all = rel_err(got, want)
    _, rel_same = rel_err(got[same], want[same])
    moved = rows - int(same.sum())
    log(f"[moe kernel] {tag} experts at {rows} rows of f32 x (not bf16 values): {moved} rows "
        f"keep other experts under x rounded to bf16; rel err vs f32 {rel_all:.3e} over all "
        f"rows, {rel_same:.3e} over the {rows - moved} others")
    return dict(rows=rows, rows_moved=moved, rel_err_all=rel_all, rel_err_same=rel_same)


def moe_load_check(tag: str, eng, c: dict, moe: dict, shared: bool) -> None:
    """The file loaded as the MoE family: its experts' config, the dense
    stacks' shapes and bf16 storage, no dense FFN, the fused FFN off."""
    import torch

    from eagle_tpu_torch.ops.ffn import supports_ffn_block

    cfg, lay = eng.model_cfg, eng.params["layers"]
    want = {"attn_norm", "ffn_norm", "wqkv", "wo", "ffn_gate_inp", "w_gate_exps", "w_up_exps",
            "w_down_exps"}
    if shared:
        want |= {"bqkv", "w_gate_shexp", "w_up_shexp", "w_down_shexp", "ffn_gate_inp_shexp"}
    e, f, d = moe["n_expert"], moe["f_exp"], c["d"]
    shapes = {"w_gate_exps": (c["n_layers"], e, f, d), "w_down_exps": (c["n_layers"], e, d, f),
              "ffn_gate_inp": (c["n_layers"], e, d)}
    if ((cfg.n_expert, cfg.n_expert_used, cfg.moe_softmax_all) != (e, moe["n_used"], shared)
            or set(lay) != want or supports_ffn_block(lay, cfg)
            or any(tuple(lay[k].shape) != v for k, v in shapes.items())
            or any(lay[k].dtype != torch.bfloat16 for k in MOE_KEYS if k in lay)):
        raise AssertionError(f"{tag}: the file did not load as its MoE family: {cfg}, "
                             f"{sorted(lay)}")


def mixtral_setup(tmp: pathlib.Path, gen, cpu) -> dict:
    """Mixtral-8x7B's shape (`MIXTRAL_8X7B`, `MIXTRAL_MOE`: Q4_K attention
    and experts, a Q6_K head, an SPM vocabulary of 32,000 pieces) at 4 of
    its 32 layers, and an EAGLE Q8_0 draft at its widths (one dense layer
    with an FFN of 14,336: yuhuili/EAGLE-mixtral-instruct-8x7B's layout),
    minted and loaded through `Engine`, the dense read checked against the
    CPU's; the CPU port's greedy tokens submitted to `cpu`; qmm at the
    path's shapes at 1, 6 and 300 rows and the draft's fc, both flash
    kernels at g = 4 (and the EAGLE prompt's 512 rows), the experts timed.
    Returns the cell's state for `mixtral_run`."""
    from eagle_tpu_torch.tokenizer import SPMTokenizer

    c = MIXTRAL_8X7B
    t0 = time.time()
    vocab = spm_vocab(c["v"], seed=263)
    out: dict = {"vocab_s": time.time() - t0}
    eng, out["files"] = family_load("mixtral-8x7b", c, tmp, 269, vocab, "llama", with_draft=True,
                                    phase="moe", moe=MIXTRAL_MOE, check=moe_dense_check)
    params, draft, cfg, dcfg = eng.params, eng.draft_params, eng.model_cfg, eng.draft_cfg
    moe_load_check("mixtral", eng, c, MIXTRAL_MOE, shared=False)
    if (not isinstance(eng.tokenizer, SPMTokenizer) or cfg.arch != "llama"
            or (dcfg.arch, dcfg.n_kv_heads) != ("eagle", 8)
            or "w_gate_up" not in draft["layers"]):
        raise AssertionError(f"mixtral: the files did not load as Mixtral + EAGLE: {cfg}")
    ids = eng.tokenizer.encode(cli_prompt(vocab["tokenizer.ggml.tokens"], FAMILY_PROMPT_TOKENS,
                                          seed=271))
    out["prompt_tokens"] = len(ids)
    head = ids[:CPU_CHECK_PROMPT]
    future = cpu.submit(cpu_tokens, cpu_copy(params), cfg, head)
    out["qmm"] = family_kernels("mixtral", params, gen, (
        (1, "qmm_gemv", "decoded token"), (VERIFY_ROWS, "qmm_mma", "verify cycle"),
        (FAMILY_PROMPT_TOKENS, "qmm_tc", "300-row prompt")), draft=draft, log_tag="moe kernel")
    out["attention"] = (gqa_flash_checks(gen, "moe kernel", c["n_heads"], c["n_kv_heads"])
                        + [gqa_prompt_check(gen, "moe kernel", c["n_heads"], c["n_kv_heads"])])
    out["experts"] = moe_ffn_times("mixtral", eng, gen)
    return dict(tag="mixtral", eng=eng, ids=ids, head=head, future=future, out=out)


def mixtral_run(st: dict) -> tuple[dict, dict]:
    """`serve_cell` on the Mixtral cell (greedy and the chain at C = 1 and
    4, eager and graphed, 2 runs each): 9 qmm_gemv and 4 flash_decode per
    decoded token, 9 qmm_mma per verify, 4 flash_prefill per greedy prompt.
    Returns (the cell, the default path's launches)."""
    import numpy as np

    eng, out = st["eng"], st["out"]
    want_tok = {"qmm_gemv": MIXTRAL_GEMV, "flash_decode": MIXTRAL_FLASH, "ffn_out_norm": 0,
                "gate_up_act": 0, "qmm": 0}
    os.environ.pop("EAGLE_TPU_FUSED_FFN", None)
    cell = serve_cell("mixtral", eng.params, eng.draft_params, eng.model_cfg, eng.draft_cfg,
                      np.asarray(st["ids"]), FAMILY_NEW, want_tok, MIXTRAL_GEMV, fused=False)
    cell.pop("gen")
    prompt = cell["variants"]["greedy graphed"]["launches_at_first_token"]
    if prompt["flash_prefill"] != MIXTRAL_FLASH or prompt["flash_decode"]:
        raise AssertionError(f"mixtral: the greedy prompt's attention launches {prompt}, "
                             f"expected {MIXTRAL_FLASH} flash_prefill")
    log(f"[mixtral] the greedy prompt: {prompt['flash_prefill']} flash_prefill, "
        f"{prompt['qmm_tc']} qmm_tc; EAGLE == greedy: "
        f"{cell['eagle_tokens'] == cell['greedy_tokens']}")
    out["cell"] = cell
    return out, dict(cell["variants"]["eagle graphed C=1"]["launches"])


def qwen_moe_setup(tmp: pathlib.Path, gen, cpu) -> dict:
    """Qwen1.5-MoE-A2.7B's shape (`QWEN_MOE_A27B`, `QWEN_MOE`: Q4_K
    attention, experts and shared expert, the experts' down products Q5_0,
    F32 routers, a Q6_K head, a 151,936-entry BPE vocabulary, pre "qwen2")
    at 8 of its 24 layers, minted and loaded through `Engine`, the dense
    read checked against the CPU's; the CPU port's greedy tokens submitted
    to `cpu`; qmm at 1 and 300 rows, both flash kernels at g = 1, the
    experts timed. Returns the cell's state for `qwen_moe_run`."""
    from eagle_tpu_torch.tokenizer import BPETokenizer

    c = QWEN_MOE_A27B
    t0 = time.time()
    vocab, words = qwen_vocab(seed=277, v=c["v"])
    out: dict = {"vocab_s": time.time() - t0}
    eng, out["files"] = family_load("qwen1.5-moe-a2.7b", c, tmp, 281, vocab, "qwen2moe",
                                    with_draft=False, phase="moe", moe=QWEN_MOE,
                                    types=QWEN_MOE_TYPES, check=moe_dense_check)
    params, cfg, tok = eng.params, eng.model_cfg, eng.tokenizer
    moe_load_check("qwen1.5-moe", eng, c, QWEN_MOE, shared=True)
    if not isinstance(tok, BPETokenizer) or not cfg.attn_bias or cfg.n_ff_exp != QWEN_MOE["f_exp"]:
        raise AssertionError(f"qwen1.5-moe: the file did not load as Qwen1.5-MoE: {cfg}")
    text = llama3_text(tok, words, FAMILY_PROMPT_TOKENS, seed=283)
    ids = tok.encode(text)
    if tok.decode(ids) != text:
        raise AssertionError("qwen1.5-moe: the prompt does not round-trip through the tokenizer")
    out["prompt_tokens"] = len(ids)
    head = ids[:CPU_CHECK_PROMPT]
    future = cpu.submit(cpu_tokens, cpu_copy(params), cfg, head)
    out["qmm"] = family_kernels("qwen1.5-moe", params, gen, (
        (1, "qmm_gemv", "decoded token"), (FAMILY_PROMPT_TOKENS, "qmm_tc", "300-row prompt")),
        log_tag="moe kernel")
    out["attention"] = gqa_flash_checks(gen, "moe kernel", c["n_heads"], c["n_kv_heads"])
    out["experts"] = moe_ffn_times("qwen1.5-moe", eng, gen)
    return dict(tag="qwen1.5-moe", eng=eng, ids=ids, head=head, future=future, out=out)


def qwen_moe_run(st: dict) -> tuple[dict, dict]:
    """`greedy_cell` on the Qwen1.5-MoE cell: 17 qmm_gemv (the 151,936-row
    head one of them) and 8 flash_decode per decoded token, 8 flash_prefill
    in the prompt. Returns (the cell, the first timed run's launches)."""
    eng, out = st["eng"], st["out"]
    os.environ.pop("EAGLE_TPU_FUSED_FFN", None)
    out["cell"], launches = greedy_cell("qwen1.5-moe", eng, st["ids"], {
        "qmm_gemv": QWEN_MOE_GEMV, "flash_decode": QWEN_MOE_FLASH, "qmm": 0})
    if launches.get("flash_prefill") != QWEN_MOE_FLASH:
        raise AssertionError(f"qwen1.5-moe: {launches.get('flash_prefill')} flash_prefill in "
                             f"the run, expected {QWEN_MOE_FLASH} (the prompt)")
    return out, launches


def moe_path(report: dict, tmp: pathlib.Path) -> dict:
    """Phase moe: the Mixtral-8x7B (+ EAGLE) and Qwen1.5-MoE-A2.7B cells,
    minted into `tmp` and loaded through `Engine` both, their kernels and
    experts checked and timed at their shapes while one worker thread runs
    the CPU port on a copy of each cell's weights (its tokens then held
    against the card's), then each run and freed. The host's resident
    memory is read before and after. Returns the launches of the Mixtral
    default path (greedy + EAGLE graphed at C = 1) and of the Qwen cell's
    first timed graphed run, added."""
    import gc
    import shutil
    from concurrent.futures import ThreadPoolExecutor

    import torch

    if shutil.disk_usage(tmp).free < 6 * 2**30:
        raise RuntimeError("phase moe needs 6 GiB of disk")
    gen = torch.Generator(device="cuda").manual_seed(259)
    out: dict = {"host_before": host_gib()}
    launches: dict = {}
    t0 = time.time()
    with ThreadPoolExecutor(max_workers=1, thread_name_prefix="cpu-port") as cpu:
        cells = [mixtral_setup(tmp, gen, cpu), qwen_moe_setup(tmp, gen, cpu)]
        for st in cells:
            st["out"]["cpu"] = cpu_tokens_finish(st["tag"], st["eng"], st["head"],
                                                 st.pop("future"))
    out["host_after_cpu_runs"] = host_gib()
    log(f"[time] moe setup (both cells' loads, kernel checks and CPU runs): "
        f"{time.time() - t0:.1f} s; host memory (GiB) before the phase "
        f"{out['host_before']}, after the CPU runs {out['host_after_cpu_runs']}")
    for st, run in zip(cells, (mixtral_run, qwen_moe_run)):
        t0 = time.time()
        tag = st["tag"]
        out[tag], part = run(st)
        st.clear()  # the engine and its weights
        gc.collect()
        torch.cuda.empty_cache()
        out[tag]["seconds"] = time.time() - t0
        log(f"[time] moe {tag}: {out[tag]['seconds']:.1f} s (the run)")
        for k, v in part.items():
            launches[k] = launches.get(k, 0) + v
    out["launches"] = launches
    report["moe_path"] = out
    return launches


def i4_route(rows: int) -> str:
    """qmm_i4's launch counter at `rows` bf16 rows at the 7B shapes."""
    return "qmm_i4" if rows == 1 else "qmm_i4_mma" if rows <= 8 else "qmm_i4_tc"


def simt_i4_ms(x, w, stack: int) -> float:
    """qmm_i4's SIMT body (the parent's route for 2-8 bf16 rows, still the
    route at 1 row and in f32) at x's rows over the stack's layers, cycled:
    launched here through its C entry, since the wrapper now routes these
    rows to the small-row body; timed beside it, not counted."""
    import torch

    from eagle_tpu_torch import _build
    from eagle_tpu_torch.ops.qmm import _I4_ARGTYPES, _KINDS, _ptr, simt_config

    fn = _build.kernel("qmm_i4_launch", _I4_ARGTYPES)
    (b, k), n = x.shape, w.shape[0]
    rb, splits, gps = simt_config(b, k, n, w.group)
    xf = x.float().contiguous()
    out = torch.empty((b, n), dtype=torch.float32, device="cuda")
    partial = torch.empty((splits, b, n), dtype=torch.float32, device="cuda")
    bias_kind = -1 if w.bias is None else _KINDS[w.bias.dtype]

    def run(i):
        layer = i % stack
        rc = fn(xf.data_ptr(), _ptr(w.q, layer), _ptr(w.scale, layer), _ptr(w.bias, layer),
                out.data_ptr(), partial.data_ptr(), b, k, n, w.group, _KINDS[w.scale.dtype],
                bias_kind, 1, rb, splits, gps, torch.cuda.current_stream().cuda_stream)
        _build.check(rc, "qmm_i4_launch")

    return device_ms(run, 20)


def qmm_i4_checks(report: dict) -> tuple[dict, dict, dict]:
    """qmm_i4 (2-D entry, layer 0) and qmm_i4_stacked (layer 5) against
    qmm_i4_plain, bf16 compute, int4 weights with bf16 scale and bias, at
    kernel_bench's default shape (N 11008, K 4096) at 1 and 8 rows and the
    7B projections (N, K) = (12288, 4096) and (4096, 11008) at 1, 2, 3, 6,
    8, 37 and 512 rows (relative error <= 1e-2); 1 row takes the SIMT body,
    2-8 rows the small-row body, 37 and 512 the wgmma body (asserted by the
    launch counters). Timed over a stack of six layers, cycled, so that
    repeats do not hit in L2; library_ms is torch.matmul on the
    pre-dequantized bf16 weight; at 2-8 rows the SIMT body that took them
    before is timed beside (`simt_ms`). Returns the default shape's rows at
    1 row (SIMT) and 8 rows (small-row body) and the wqkv row at 512 rows,
    each with the worst error of its body."""
    import torch

    from eagle_tpu_torch import _build
    from eagle_tpu_torch.ops.qmm import qmm_i4, qmm_i4_plain, qmm_i4_stacked

    gen = torch.Generator(device="cuda").manual_seed(17)
    stack, bf16 = 6, torch.bfloat16
    results, rows_of = [], {}
    worst = {"qmm_i4": 0.0, "qmm_i4_mma": 0.0, "qmm_i4_tc": 0.0}
    for name, n, k, rows_list in (("kernel_bench", 11008, 4096, (1, 8)),
                                  ("wqkv", 12288, 4096, I4_ROWS),
                                  ("w_down", 4096, 11008, I4_ROWS)):
        w = int4_stack(gen, n, k, stack)
        layers = [w.layer(i) for i in range(stack)]
        dense = [lw.dequantize(bf16).T.contiguous() for lw in layers]  # [K, N]
        w_bytes = nbytes(*layers[0].tensors().values())
        for rows in rows_list:
            x = torch.randn((rows, k), generator=gen, device="cuda")
            route = i4_route(rows)
            _build.reset_counts()
            for entry, got, want in (
                    ("2-D", qmm_i4(x, layers[0]), qmm_i4_plain(x, layers[0])),
                    ("stacked", qmm_i4_stacked(x, w, 5), qmm_i4_plain(x, layers[5]))):
                torch.cuda.synchronize()
                abs_err, rel = rel_err(got, want)
                if rel > QMM_TOL or not bool(torch.isfinite(got).all()):
                    raise AssertionError(f"qmm_i4 {entry} {name} rows={rows}: rel err {rel:.3e}")
                worst[route] = max(worst[route], abs_err)
            if _build.launches[route] != 2 or sum(_build.launches.values()) != 2:
                raise AssertionError(f"qmm_i4 {name} rows={rows}: not the {route} route: "
                                     f"{_build.launches}")
            reps = 20 if rows < 512 else 5
            ms = device_ms(lambda i: qmm_i4_stacked(x, w, i % stack), reps)
            plain = device_ms(lambda i: qmm_i4_plain(x, layers[i % stack]), 3, warmup=1)
            xb = x.to(bf16)
            lib = device_ms(lambda i: torch.matmul(xb, dense[i % stack]), reps)
            b_ms, b_by = bound_ms(w_bytes + rows * k * 4 + rows * n * 4, 2.0 * rows * k * n)
            res = dict(name=name, n=n, k=k, rows=rows, route=route, ms=ms, plain_ms=plain,
                       bound_ms=b_ms, bound_by=b_by, library_ms=lib, max_abs_err=abs_err,
                       rel_err=rel, weight_bytes=w_bytes)
            simt = ""
            if route == "qmm_i4_mma":
                res["simt_ms"] = simt_i4_ms(x, w, stack)
                simt = f"  SIMT body {res['simt_ms']:8.4f} ms = {res['simt_ms'] / ms:.2f}x this"
            results.append(res)
            log(f"[qmm_i4] {name:12s} N={n:5d} K={k:5d} rows={rows:3d}  kernel {ms:8.4f} ms  "
                f"plain {plain:8.3f} ms  bound {b_ms * 1e3:8.2f} us ({b_by})  "
                f"library {lib:8.4f} ms  rel err {rel:.2e}{simt}")
            if rows in (1, 8, 37, 512):
                log_ratios("qmm_i4", res)
            if (name == "kernel_bench" and rows in (1, 8)) or (name == "wqkv" and rows == 512):
                rows_of[route] = dict(res)
        del w, layers, dense
        torch.cuda.empty_cache()
    report["qmm_i4"] = results
    for route, res in rows_of.items():
        res["max_abs_err"] = worst[route]
    return rows_of["qmm_i4"], rows_of["qmm_i4_mma"], rows_of["qmm_i4_tc"]


def kernel_bench_path(report: dict) -> dict:
    """The slice's path: `python -m eagle_tpu_torch.tools.kernel_bench` at
    its defaults (K 4096, N 11008, 8 rows, G 32) with every ported variant.
    Each variant's output is first held against its plain version (outside
    the counted run), then the benchmark runs without the check: the launch
    counts come from that run alone. Returns its launch counts."""
    import torch

    from eagle_tpu_torch import _build
    from eagle_tpu_torch.tools import kernel_bench as kb

    runs = {}
    # the defaults (8 rows: the small-row tensor-core body of qmm and
    # qmm_i4), then the int4 variants at 1 row (qmm_i4's SIMT body) and at a
    # 512-row prefill (the wgmma body of qmm_i4)
    for tag, argv in (("default", ["--variants", ",".join(kb.VARIANTS)]),
                      ("1 row", ["--variants", "int4,i4stacked", "--b", "1"]),
                      ("512 rows", ["--variants", "int4,i4stacked", "--b", "512"])):
        args = kb.parse_args(argv)
        log(f"[kernel_bench] {tag}: x[{args.b}, {args.k}] @ W[{args.k}, {args.n}], G={args.group}")
        bench = kb.Bench(args, kb.variant_names(args.variants), torch.device("cuda"))
        checked = bench.check()
        _build.reset_counts()  # ---- this path: counts from here ----
        timed = bench.time()
        launches, plain = dict(_build.launches), dict(_build.plain_calls)  # ---- ends ----
        log(f"[kernel_bench] {tag}: launches {launches}; plain versions {plain}")
        want = {"default": ("qmm_mma", "qmm_i4_mma"), "1 row": ("qmm_i4",),
                "512 rows": ("qmm_i4_tc",)}[tag]
        if any(launches[k] <= 0 for k in want):
            raise AssertionError(f"kernel_bench {tag} did not launch {want}: {launches}")
        if any(plain.values()):
            raise AssertionError(f"plain versions ran in the timed kernel_bench run: {plain}")
        runs[tag] = dict(checked=checked, timed=timed, launches=launches)
    report["kernel_bench"] = runs
    return {"qmm_i4": runs["1 row"]["launches"]["qmm_i4"],
            "qmm_i4_mma": runs["default"]["launches"]["qmm_i4_mma"],
            "qmm_i4_tc": runs["512 rows"]["launches"]["qmm_i4_tc"]}


# --------------------------------------------------------------------------
# phase 8: the remaining GGUF formats


NEW_FORMATS = ("Q4_1", "Q5_0", "Q5_1", "Q8_1", "Q2_K", "Q3_K", "Q5_K", "IQ4_NL", "IQ4_XS",
               "IQ2_XXS", "IQ2_XS", "IQ2_S", "IQ3_XXS", "IQ3_S", "IQ1_S", "IQ1_M")


def format_checks(report: dict) -> list[dict]:
    """Each format the port added in this slice: one [11008 x 4096] tensor of
    random blocks (finite f16 scales) written with the port's writer, loaded
    "kn" with the repack on the card and on the CPU (equal bit for bit),
    prepared for serving ("f32": Q4_1 nibble-packs), then qmm against its
    plain version at 1, 6 and 512 rows (relative error <= 1e-2). Q5_K goes
    through the coded load too. Times at 1 row are taken over copies of the
    weight that take twice the L2."""
    import math
    import tempfile

    import torch

    from eagle_tpu_torch.gguf import GGMLType, GGUFReader, GGUFWriter
    from eagle_tpu_torch.models.loader import load_tensor
    from eagle_tpu_torch.ops.qmm import qmm, qmm_plain
    from eagle_tpu_torch.quant.serving import prepare_qtensor

    gen = torch.Generator(device="cuda").manual_seed(23)
    n, k = 11008, 4096
    results = []
    saved = os.environ.get("EAGLE_TPU_CODED_LOAD")
    with tempfile.TemporaryDirectory(prefix="eagle_formats_") as tmp_name:
        path = pathlib.Path(tmp_name) / "formats.gguf"
        w = GGUFWriter(path)
        w.add("general.architecture", "llama")
        for name in NEW_FORMATS:
            w.add_tensor(name, random_blocks(gen, n, k, int(GGMLType[name]), 1e-3, True),
                         GGMLType[name], raw_shape=(n, k))
        w.write()
        del w
        reader = GGUFReader(path)
        cases = [(name, "0") for name in NEW_FORMATS] + [("Q5_K", "1")]
        for name, coded in cases:
            os.environ["EAGLE_TPU_CODED_LOAD"] = coded
            t0 = time.time()
            card = load_tensor(reader, name, layout="kn", device="cuda")
            torch.cuda.synchronize()
            t_card = time.time() - t0
            host = load_tensor(reader, name, layout="kn", device="cpu")
            same = (card.group, card.coded, card.ggml_type) == (host.group, host.coded,
                                                                host.ggml_type) and all(
                same_bits(card.tensors()[f], host.tensors()[f]) for f in card.tensors())
            if not same:
                raise AssertionError(f"{name}: repack on the card differs from the CPU's")
            for f, t in card.tensors().items():
                if t is not None and t.is_floating_point() and not bool(torch.isfinite(t).all()):
                    raise AssertionError(f"{name}: non-finite {f}")
            wq = prepare_qtensor(card, "f32")
            del host
            tag = f"{name}{' coded' if coded == '1' else ''}"
            w_bytes = nbytes(*wq.tensors().values())
            worst = 0.0
            for rows in (1, 6, 512):
                x = torch.randn((rows, k), generator=gen, device="cuda")
                got, want = qmm(x, wq), qmm_plain(x, wq)
                torch.cuda.synchronize()
                abs_err, rel = rel_err(got, want)
                if rel > QMM_TOL or not bool(torch.isfinite(got).all()):
                    raise AssertionError(f"qmm {tag} rows={rows}: rel err {rel:.3e} > {QMM_TOL}")
                worst = max(worst, rel)
            x = torch.randn((1, k), generator=gen, device="cuda")
            c = max(2, math.ceil(2 * 50 * 2**20 / w_bytes))
            ws = [wq] + [dataclasses.replace(wq, **{f: None if t is None else t.clone()
                                                   for f, t in wq.tensors().items()})
                         for _ in range(c - 1)]
            ms = device_ms(lambda i: qmm(x, ws[i % c]), 20)
            plain = device_ms(lambda i: qmm_plain(x, ws[i % c]), 3, warmup=1)
            dense = [wq.dequantize(torch.bfloat16).T.contiguous(), None]
            dense[1] = dense[0].clone()
            xb = x.to(torch.bfloat16)
            lib = device_ms(lambda i: torch.matmul(xb, dense[i % 2]), 20)
            b_ms, b_by = bound_ms(w_bytes + k * 4 + n * 4, 2.0 * k * n)
            res = dict(format=tag, group=wq.group, packed=wq.packed, coded=wq.coded,
                       load_card_s=t_card, weight_bytes=w_bytes, ms=ms, plain_ms=plain,
                       bound_ms=b_ms, bound_by=b_by, library_ms=lib, worst_rel_err=worst,
                       copies=c)
            results.append(res)
            log(f"[format] {tag:10s} G={wq.group:2d}{' packed' if wq.packed else ''}: card repack "
                f"== CPU repack; qmm 1/6/512 rows rel err <= {worst:.1e}; 1 row: kernel "
                f"{ms:8.4f} ms  plain {plain:7.3f} ms  bound {b_ms * 1e3:6.2f} us ({b_by})  "
                f"library {lib:7.4f} ms  ({w_bytes / 1e6:.1f} MB, {c} copies)")
            del card, wq, ws, dense
            torch.cuda.empty_cache()
        reader.close()
    if saved is None:
        os.environ.pop("EAGLE_TPU_CODED_LOAD", None)
    else:
        os.environ["EAGLE_TPU_CODED_LOAD"] = saved
    report["formats"] = results
    return results


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="chiprun_out", help="directory for the detailed report")
    ap.add_argument("--parent-report", default=None,
                    help="chip_smoke_report.json written by another tree on the same card: "
                         "print each qmm/qmm_i4 and timed flash time as a ratio to its kernel "
                         "there")
    args = ap.parse_args()

    import torch

    # torch.profiler warns once on reuse; stderr stays clean after the result
    warnings.filterwarnings("ignore", message="Warning: Profiler clears events")
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on the card only",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out_dir = pathlib.Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    t_start = time.time()
    seconds: dict[str, float] = {}

    def phase(name: str, fn, *a):
        t0 = time.time()
        out = fn(*a)
        seconds[name] = time.time() - t0
        log(f"[time] phase {name}: {seconds[name]:.1f} s")
        return out

    load_parent(args.parent_report)
    card = phase("1", phase_device, out_dir)
    report: dict = {"card": card, "phase_seconds": seconds}
    gemv_row, qmm_tc_row, qmm_mma_row = phase("2 qmm", qmm_checks, report)
    simt_row = phase("2 ragged", ragged_checks, report)
    i4_mma_check_err = phase("2 qmm_i4", qmm_i4_small_row_checks, report)
    out_norm_row, gate_up_row = phase("2 ffn", ffn_checks, report)
    dec_row, pre_row = phase("2 attention", attention_checks, report)
    tiny_launches = phase("2 tiny model", tiny_model_check)
    # a copy: the main path's own counts stay as its report holds them
    main_launches, q4k = phase("3-5", main_path, report)
    launches = dict(main_launches)
    tree_launches = phase("tree", tree_phase, report, q4k)
    del q4k
    # the later kernels' counts come from the paths that run them
    with tempfile.TemporaryDirectory(prefix="eagle_gguf_") as tmp:  # phases 6 and cli
        gguf_launches, target, draft = phase("6", gguf_path, report, pathlib.Path(tmp))
        phase("cli", cli_path, report, target, draft)
        chat_launches = phase("chat", chat_path, report, target, draft, pathlib.Path(tmp))
        serve_launches = phase("serve", serve_path, report, target, draft, pathlib.Path(tmp))
        paged_launches = phase("paged", paged_path, report, target, draft, pathlib.Path(tmp))
        constrained_launches = phase("constrained", constrained_path, report, target, draft,
                                     pathlib.Path(tmp))
        runtime_launches = phase("runtime", runtime_path, report, target, pathlib.Path(tmp))
    with tempfile.TemporaryDirectory(prefix="eagle_llama3_") as tmp:  # phase 6's files are gone
        llama3_launches = phase("llama3", llama3_path, report, pathlib.Path(tmp))
    with tempfile.TemporaryDirectory(prefix="eagle_families_") as tmp:
        families_launches = phase("families", families_path, report, pathlib.Path(tmp))
    with tempfile.TemporaryDirectory(prefix="eagle_layernorm_") as tmp:
        layernorm_launches = phase("layernorm", layernorm_path, report, pathlib.Path(tmp))
    with tempfile.TemporaryDirectory(prefix="eagle_positions_") as tmp:
        positions_launches = phase("positions", positions_path, report, pathlib.Path(tmp))
    with tempfile.TemporaryDirectory(prefix="eagle_lnfamilies_") as tmp:
        lnfamilies_launches = phase("lnfamilies", lnfamilies_path, report, pathlib.Path(tmp))
    with tempfile.TemporaryDirectory(prefix="eagle_moe_") as tmp:
        moe_launches = phase("moe", moe_path, report, pathlib.Path(tmp))
    for k in ("ffn_out_norm", "gate_up_act"):
        launches[k] = gguf_launches[k]
    i4_row, i4_mma_row, i4_tc_row = phase("7 qmm_i4", qmm_i4_checks, report)
    i4_mma_row["max_abs_err"] = max(i4_mma_row["max_abs_err"], i4_mma_check_err)
    launches.update(phase("7 kernel_bench", kernel_bench_path, report))
    phase("8", format_checks, report)

    sources = {"qmm": "eagle_tpu_torch/csrc/qmm.cu",
               "qmm_gemv": "eagle_tpu_torch/csrc/qmm_gemv.cuh",
               "flash_decode": "eagle_tpu_torch/csrc/flash_attention.cu",
               "flash_prefill": "eagle_tpu_torch/csrc/flash_attention.cu",
               "ffn_out_norm": "eagle_tpu_torch/csrc/ffn_tensor_core.cu",
               "gate_up_act": "eagle_tpu_torch/csrc/ffn_tensor_core.cu",
               "qmm_i4": "eagle_tpu_torch/csrc/qmm_i4.cu",
               "qmm_tc": "eagle_tpu_torch/csrc/qmm_tc.cuh",
               "qmm_i4_tc": "eagle_tpu_torch/csrc/qmm_i4.cu",
               "qmm_mma": "eagle_tpu_torch/csrc/qmm_mma.cuh",
               "qmm_i4_mma": "eagle_tpu_torch/csrc/qmm_mma.cuh"}

    def row(name, replaces, vals):
        return {"name": name, "route": "cuda", "source": sources[name],
                "replaces": replaces, "launches": launches[name],
                "max_abs_err": vals["max_abs_err"], "ms": vals["ms"],
                "plain_ms": vals["plain_ms"], "bound_ms": vals["bound_ms"],
                "bound_by": vals["bound_by"], "library_ms": vals["library_ms"],
                "tree_path_launches": {k: c[name] for k, c in tree_launches.items()},
                "serve_path_launches": serve_launches[name],
                "paged_path_launches": paged_launches[name],
                "constrained_path_launches": constrained_launches.get(name, 0),
                "runtime_path_launches": runtime_launches.get(name, 0),
                "llama3_path_launches": llama3_launches.get(name, 0),
                "families_path_launches": families_launches.get(name, 0),
                "layernorm_path_launches": layernorm_launches.get(name, 0),
                "positions_path_launches": positions_launches.get(name, 0),
                "lnfamilies_path_launches": lnfamilies_launches.get(name, 0),
                "moe_path_launches": moe_launches.get(name, 0),
                "chat_path_launches": chat_launches.get(name, 0)}

    vs_parent_d256 = {}  # --parent-report: the parent's time of each D = 256 row

    def d256_row(name, t, case=""):
        """The kernel at Gemma-7B's D = 256 shape (bf16, phase 2), its body
        and its launches in the gemma cell's default path (flash_decode
        also by route). The parent's time there, measured by another run,
        goes to the report's "vs_parent", not to this row."""
        r = next(r for r in report["attention_d256"] if (
            r["name"], r["model"], r["dtype"], r["t"], r.get("case", "")) == (
                name, "gemma-7b", "bfloat16", t, case) and "ms" in r)
        gemma = report["families_path"]["gemma"]["cell"]["variants"]["eagle graphed C=1"]
        shape = (f"T={t}, S={r['s']}, 16 heads x 256 (Gemma-7B), bf16 cache"
                 + (f", {case} layout" if case else ""))
        if PARENT:
            vs_parent_d256[f"{name} {shape}"] = {
                "ms": r["ms"], "parent_ms": PARENT.get(("flash", flash_label(r), 0))}
        out = {k: r[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                 "max_abs_err")} | {
            "shape": shape, "body": r["plan"]["body"],
            "gemma_path_launches": gemma["launches"][name]}
        if name == "flash_decode":
            out["gemma_path_launches_by_route"] = {
                k: gemma["launches"][f"flash_decode_{k}"] for k in ("mma_cluster", "wgmma")}
        return out

    def cell_checks(path, cell, name):
        """The kernel's checks in one cell of a phase: g = 48 (StarCoder-15B,
        phase positions), g = 71 at D = 64 (Falcon-7B), g = 6 (Minitron-8B)
        and GPT-J's 16 / 16 heads of 256 (phase lnfamilies), g = 4
        (Mixtral-8x7B) and g = 1 (Qwen1.5-MoE, phase moe)."""
        return [{k: r[k] for k in ("t", "s", "ms", "plain_ms", "bound_ms", "bound_by",
                                   "library_ms", "max_abs_err")}
                for r in report[path][cell]["attention"] if r["name"] == name]

    def g48(name):
        return cell_checks("positions_path", "starcoder", name)

    def lnf(name):
        return {f"{cell} ({shape})": cell_checks("lnfamilies_path", cell, name)
                for cell, shape in (("falcon", "g = 71, 71 / 1 heads of 64"),
                                    ("minitron", "g = 6, 48 / 8 heads of 128"),
                                    ("gptj", "16 / 16 heads of 256"))}

    def moe(name):
        return {f"{cell} ({shape})": cell_checks("moe_path", cell, name)
                for cell, shape in (("mixtral", "g = 4, 32 / 8 heads of 128"),
                                    ("qwen1.5-moe", "g = 1, 16 / 16 heads of 128"))}

    kernels = [
        dict(row("qmm", "eagle_tpu/ops/pallas_qmm.py:513 and :758", simt_row),
             shape="SIMT body (csrc/qmm_body.cuh): Q4_0 [4001 x 4096], 1 row (N % 4 != 0)",
             launches_per_decoded_token=report["main_path"]["launches_per_decoded_token"]["qmm"],
             launches_from="phases 3-4 (no main-path product takes the SIMT body)",
             f32_model_launches=tiny_launches["qmm"]),
        dict(row("qmm_gemv", "eagle_tpu/ops/pallas_qmm.py:513 and :758", gemv_row),
             shape="one decoded token: 32 x (wqkv, wo, w_gate_up, w_down) + lm_head, 1 row, "
                   "Q4_K packed coded (1-row tensor-core body, csrc/qmm_gemv.cuh)",
             launches_per_decoded_token=report["main_path"]["launches_per_decoded_token"][
                 "qmm_gemv"],
             launches_from="phases 3-4: greedy decode and the EAGLE draft"),
        dict(row("flash_decode", "eagle_tpu/ops/pallas_attention.py:116", dec_row),
             shape="T=1, S=1024, 32 heads x 128, bf16 cache",
             head_dim_256=[dict(d256_row("flash_decode", 1),
                                source="eagle_tpu_torch/csrc/flash_attention.cu"),
                           dict(d256_row("flash_decode", VERIFY_ROWS),
                                source="eagle_tpu_torch/csrc/flash_attention.cu"),
                           dict(d256_row("flash_decode", 512, "eagle prompt"),
                                source="eagle_tpu_torch/csrc/flash_wgmma.cu")],
             g48=g48("flash_decode"), lnfamilies=lnf("flash_decode"), moe=moe("flash_decode")),
        dict(row("flash_prefill", "eagle_tpu/ops/pallas_attention.py:249", pre_row),
             shape="T=512, S=512, 32 heads x 128, bf16 cache",
             head_dim_256=dict(d256_row("flash_prefill", 512, "generator"),
                               source="eagle_tpu_torch/csrc/flash_wgmma.cu"),
             g48=g48("flash_prefill"), lnfamilies=lnf("flash_prefill"),
             moe=moe("flash_prefill"),
             chat_feeds=[{k: v for k, v in r.items() if k in (
                 "t", "n", "q0", "s", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                 "max_abs_err")} for r in report["attention"] if "feed" in r.get("what", "")]),
        dict(row("ffn_out_norm", "eagle_tpu/ops/pallas_ffn.py:257 and :265", out_norm_row),
             shape="1 row, wo [4096 x 4096] Q4_0 packed, f32 scale and bias, + resid, RMSNorm",
             launches_from="GGUF path, EAGLE_TPU_FUSED_FFN=1"),
        dict(row("gate_up_act", "eagle_tpu/ops/pallas_ffn.py:413 and :419", gate_up_row),
             shape="1 row, w_gate_up [4096 x 22016] Q4_0 packed, f32 scale and bias, SiLU (matmul "
                   "pass on the 1-row body, paired, csrc/qmm_gemv.cuh)",
             launches_from="GGUF path, EAGLE_TPU_FUSED_FFN=1"),
        dict(row("qmm_i4", "eagle_tpu/ops/pallas_qmm.py:600 and :839", i4_row),
             shape="kernel_bench shape, 1 row: [4096 x 11008] int4, G 32, bf16 scale and bias "
                   "(SIMT body)",
             launches_from="kernel_bench --b 1, variants int4 and i4stacked"),
        dict(row("qmm_i4_mma", "eagle_tpu/ops/pallas_qmm.py:600 and :839", i4_mma_row),
             shape="kernel_bench default: 8 rows, [4096 x 11008] int4, G 32, bf16 scale and bias "
                   "(small-row mma.sync body, csrc/qmm_mma.cuh via csrc/qmm_i4.cu)",
             main_path_launches=report["main_path"]["launches"]["qmm_i4_mma"],
             launches_from="kernel_bench at its defaults, every ported variant (no model path "
                           "makes int4 weights)"),
        dict(row("qmm_tc", "eagle_tpu/ops/pallas_qmm.py:513 and :758", qmm_tc_row),
             shape="prefill: wqkv [12288 x 4096] Q4_K packed coded, 512 rows (tensor-core body, "
                   "csrc/qmm_tc.cuh)",
             launches_per_prompt=report["main_path"]["launches_at_first_token"]["qmm_tc"],
             launches_from="phases 3-4: greedy and EAGLE prompts"),
        dict(row("qmm_i4_tc", "eagle_tpu/ops/pallas_qmm.py:600 and :839", i4_tc_row),
             shape="prefill: wqkv [12288 x 4096] int4, G 32, bf16 scale and bias, 512 rows "
                   "(tensor-core body, csrc/qmm_tc.cuh)",
             launches_from="kernel_bench --b 512, variants int4 and i4stacked"),
        dict(row("qmm_mma", "eagle_tpu/ops/pallas_qmm.py:513 and :758", qmm_mma_row),
             shape="verify: wqkv [12288 x 4096] Q4_K packed coded, 6 rows (small-row mma.sync "
                   "body, csrc/qmm_mma.cuh)",
             launches_per_verify_cycle=VERIFY_QMM,
             launches_from="phases 3-4: the EAGLE chain's verify forwards"),
    ]
    report["kernels"] = kernels
    if vs_parent_d256:
        report["vs_parent"] = vs_parent_d256
    report["seconds"] = time.time() - t_start
    (out_dir / "chip_smoke_report.json").write_text(json.dumps(report, indent=1))
    log(f"[done] {report['seconds']:.1f} s; report in {out_dir / 'chip_smoke_report.json'}")
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
