"""Self-contained live metrics dashboard served at GET /
(reference: scratchpad/server/server.py:76-79 metrics_ui.html). Pure
inline HTML/JS polling /system_info and /metrics — no external assets,
works over SSH tunnels. A copy of ``scratchpad_tpu/server/metrics_ui.py``:
the port's metrics keep the JAX package's names."""

DASHBOARD_HTML = """<!doctype html>
<html><head><meta charset="utf-8"><title>scratchpad-tpu</title>
<style>
 body{font-family:system-ui,sans-serif;margin:2rem;background:#111;color:#eee}
 h1{font-size:1.2rem} .grid{display:grid;grid-template-columns:repeat(auto-fill,minmax(220px,1fr));gap:12px}
 .card{background:#1c1c1e;border:1px solid #333;border-radius:8px;padding:12px}
 .card .v{font-size:1.6rem;font-weight:600;margin-top:4px}
 .card .l{color:#9a9a9f;font-size:.8rem;text-transform:uppercase;letter-spacing:.05em}
 table{border-collapse:collapse;margin-top:1.5rem;width:100%;font-size:.85rem}
 td,th{border-bottom:1px solid #2a2a2e;padding:6px 10px;text-align:left}
 #err{color:#f66}
</style></head><body>
<h1>scratchpad-tpu <span id="model"></span></h1><div id="err"></div>
<div class="grid" id="cards"></div>
<table id="hist"><thead><tr><th>latency</th><th>count</th><th>p50</th><th>p90</th><th>p99</th></tr></thead><tbody></tbody></table>
<script>
const CARDS=[["num_running","running"],["num_waiting","queued"],
 ["generated_tokens","tokens generated"],["gen_tput","gen tok/s"],
 ["kv_usage","KV usage %"],["retractions","retractions"],
 ["spec_accepted_tokens","spec accepted"],["host_kv_stored_pages","host KV pages"]];
function card(id,label,val){return `<div class="card"><div class="l">${label}</div><div class="v" id="${id}">${val}</div></div>`}
function parseProm(text){const out={};for(const line of text.split("\\n")){
 if(line.startsWith("#")||!line.trim())continue;
 const sp=line.lastIndexOf(" ");out[line.slice(0,sp)]=parseFloat(line.slice(sp+1));}return out}
function pct(buckets,total,q){let need=total*q;for(const [le,c] of buckets){if(c>=need)return le}return "inf"}
async function tick(){try{
 const si=await (await fetch("/system_info")).json();
 document.getElementById("model").textContent=si.model||"";
 const kv=100*(1-si.kv_pages_free/Math.max(si.kv_pages_total,1));
 const m=parseProm(await (await fetch("/metrics")).text());
 const tput=m['scratchpad_tpu:gen_throughput']??0;
 const vals={num_running:si.num_running,num_waiting:si.num_waiting,
  generated_tokens:si.generated_tokens,gen_tput:tput.toFixed(1),
  kv_usage:kv.toFixed(1),retractions:si.retractions,
  spec_accepted_tokens:si.spec_accepted_tokens,host_kv_stored_pages:si.host_kv_stored_pages};
 document.getElementById("cards").innerHTML=CARDS.map(([k,l])=>card(k,l,vals[k])).join("");
 const rows=[];
 for(const h of ["time_to_first_token_seconds","inter_token_latency_seconds",
                 "time_per_output_token_seconds","e2e_request_latency_seconds"]){
   const pre=`scratchpad_tpu:${h}`;const total=m[`${pre}_count`];
   if(!total)continue;
   const buckets=Object.entries(m).filter(([k])=>k.startsWith(`${pre}_bucket`))
     .map(([k,v])=>[k.match(/le="([^"]+)"/)[1],v])
     .sort((a,b)=>parseFloat(a[0])-parseFloat(b[0]));
   rows.push(`<tr><td>${h.replace(/_seconds$/,"")}</td><td>${total}</td>`+
     [0.5,0.9,0.99].map(q=>`<td>&le; ${pct(buckets,total,q)}s</td>`).join("")+"</tr>");
 }
 document.querySelector("#hist tbody").innerHTML=rows.join("");
 document.getElementById("err").textContent="";
}catch(e){document.getElementById("err").textContent="fetch failed: "+e}}
tick();setInterval(tick,2000);
</script></body></html>"""
